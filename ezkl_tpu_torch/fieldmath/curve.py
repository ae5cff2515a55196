"""Batched BN254 G1 arithmetic (port of `ezkl_tpu/fieldmath/curve.py`).

Points are projective (X:Y:Z) triples of Fq limb tensors ((8, *batch) each,
Montgomery form), added with the complete formulas of Renes-Costello-Batina
2015 (a = 0): no exceptional cases. Identity is (0:1:0). `add` and `dbl` are
kernels K3 and K9 (`kernels/pcurve.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import limbs
from .spec import bn254_fq, NWORDS

B_COEFF = 3       # y^2 = x^3 + 3
B3 = 9            # 3*b, used by the complete formulas

G1_X = 1
G1_Y = 2


class PointP(NamedTuple):
    """Projective point; each coord is an (8, *batch) int32 limb tensor."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[1:])

    @property
    def device(self):
        return self.x.device

    def map(self, fn) -> "PointP":
        return PointP(fn(self.x), fn(self.y), fn(self.z))


def identity(batch_shape=(), device=None) -> PointP:
    fq = bn254_fq()
    return PointP(
        x=limbs.zeros(batch_shape, device),
        y=limbs.ones_mont(fq, batch_shape, device).contiguous(),
        z=limbs.zeros(batch_shape, device),
    )


def is_identity(p: PointP):
    return limbs.is_zero(p.z)


def select_point(mask, a: PointP, b: PointP) -> PointP:
    """mask: batch bool -> a where true else b."""
    return PointP(limbs.select(mask, a.x, b.x), limbs.select(mask, a.y, b.y),
                  limbs.select(mask, a.z, b.z))


def neg(p: PointP) -> PointP:
    return PointP(p.x, limbs.neg(bn254_fq(), p.y), p.z)


def add(p: PointP, q: PointP) -> PointP:
    """Complete projective addition (RCB15 algorithm 7) -- kernel K3."""
    from ..kernels import pcurve
    return pcurve.point_add(p, q)


def dbl(p: PointP) -> PointP:
    """Complete projective doubling (RCB15 algorithm 9) -- kernel K9."""
    from ..kernels import pcurve
    return pcurve.point_dbl(p)


def to_affine(p: PointP):
    """Batch-normalize to affine (x, y); identity lanes -> (0, 0)."""
    fq = bn254_fq()
    zinv = limbs.inv(fq, p.z)  # inv(0) == 0
    return limbs.mont_mul(fq, p.x, zinv), limbs.mont_mul(fq, p.y, zinv)


def from_affine(x, y, is_inf=None) -> PointP:
    fq = bn254_fq()
    pt = PointP(x, y, limbs.ones_mont(fq, x.shape[1:], x.device).contiguous())
    if is_inf is not None:
        pt = select_point(is_inf, identity(x.shape[1:], x.device), pt)
    return pt


def scalar_mul(p: PointP, scalar_bits) -> PointP:
    """Double-and-add over MSB-first scalar bits (256, *batch) of 0/1."""
    acc = identity(p.batch_shape, p.device)
    for i in range(scalar_bits.shape[0]):
        acc = dbl(acc)
        acc = select_point(scalar_bits[i].bool(), add(acc, p), acc)
    return acc


def scalars_to_bits(scalars_raw) -> torch.Tensor:
    """(8, *batch) NON-Montgomery limb scalars -> (256, *batch) bits,
    MSB first."""
    w = limbs._w(scalars_raw)
    shifts = torch.arange(31, -1, -1, device=w.device).reshape(
        (1, 32) + (1,) * (w.dim() - 1))
    bits = (w.flip(0)[:, None] >> shifts) & 1               # (8, 32, *batch)
    return bits.reshape((NWORDS * 32,) + tuple(w.shape[1:])).to(torch.int32)


def generator(batch_shape=(), device=None) -> PointP:
    fq = bn254_fq()
    nd = len(tuple(batch_shape))
    shape = (NWORDS,) + tuple(batch_shape)
    gx = limbs.bcast_const(fq, G1_X, nd, device=device).expand(shape).contiguous()
    gy = limbs.bcast_const(fq, G1_Y, nd, device=device).expand(shape).contiguous()
    return from_affine(gx, gy)


def encode_points(points, device=None) -> PointP:
    """List of (x, y) int tuples or None (identity) -> batched PointP."""
    fq = bn254_fq()
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0]), ys.append(pt[1]), zs.append(1)
    return PointP(*(limbs.to_device(limbs.encode(fq, v), device) for v in (xs, ys, zs)))


def decode_points(p: PointP):
    """Batched PointP -> list of (x, y) int tuples or None for identity."""
    fq = bn254_fq()
    ax, ay = to_affine(p)
    inf = is_identity(p).reshape(-1).cpu().numpy()
    xs = limbs.decode(fq, ax).reshape(-1)
    ys = limbs.decode(fq, ay).reshape(-1)
    return [None if inf[i] else (int(xs[i]), int(ys[i])) for i in range(len(xs))]

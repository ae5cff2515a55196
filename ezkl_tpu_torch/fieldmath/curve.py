"""Batched BN254 G1 arithmetic (port of `ezkl_tpu/fieldmath/curve.py`).

Points are projective (X:Y:Z) triples of Fq limb tensors ((8, *batch) each,
Montgomery form), added with the complete formulas of Renes-Costello-Batina
2015 (a = 0): no exceptional cases. Identity is (0:1:0). `add` and `dbl` are
kernels K3 and K9 (`kernels/pcurve.py`); `add_mixed` (algorithm 8, an affine
second operand) composes the field operations, as the JAX package does.
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


def add_mixed(p: PointP, qx, qy, q_is_identity=None) -> PointP:
    """p + (qx, qy, 1) by RCB15 algorithm 8 (11 products), the schedule of
    the JAX package's `curve.add_mixed`; the products are K1 on the card.
    Where `q_is_identity` (batch bool) is set, the lane returns p."""
    fq = bn254_fq()
    mul = lambda a, b: limbs.mont_mul(fq, a, b)                # noqa: E731
    fadd = lambda a, b: limbs.add(fq, a, b)                    # noqa: E731
    fsub = lambda a, b: limbs.sub(fq, a, b)                    # noqa: E731

    def xb3(a):                                                # 9a = 8a + a
        t = fadd(a, a)
        t = fadd(t, t)
        return fadd(fadd(t, t), a)

    X1, Y1, Z1 = p
    X2, Y2 = qx, qy
    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t3 = fadd(X2, Y2)
    t4 = fadd(X1, Y1)
    t3 = mul(t3, t4)
    t4 = fadd(t0, t1)
    t3 = fsub(t3, t4)
    t4 = mul(Y2, Z1)
    t4 = fadd(t4, Y1)
    Y3 = mul(X2, Z1)
    Y3 = fadd(Y3, X1)
    X3 = fadd(t0, t0)
    t0 = fadd(X3, t0)
    t2 = xb3(Z1)
    Z3 = fadd(t1, t2)
    t1 = fsub(t1, t2)
    Y3 = xb3(Y3)
    X3 = mul(t4, Y3)
    t2 = mul(t3, t1)
    X3 = fsub(t2, X3)
    Y3 = mul(Y3, t0)
    t1 = mul(t1, Z3)
    Y3 = fadd(t1, Y3)
    t0 = mul(t0, t3)
    Z3 = mul(Z3, t4)
    Z3 = fadd(Z3, t0)
    out = PointP(X3, Y3, Z3)
    if q_is_identity is not None:
        out = select_point(q_is_identity, p, out)
    return out


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

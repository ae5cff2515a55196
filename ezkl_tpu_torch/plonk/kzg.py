"""KZG polynomial commitments and openings (port of `ezkl_tpu/plonk/kzg.py`).

commit(evals over H) = iNTT then the fused Pippenger MSM over the monomial SRS,
whose points are affine (z = 1), so the MSM runs its mixed-add scan
(`affine=True`), as the JAX package's commitments do; opening
witnesses are computed in evaluation form, W = (p - p(z)) / (X - z) on H via
one `batch_inv`; p(z) by the barycentric formula. Under an active mesh
(`parallel.sharded.set_mesh`, EZKL_TPU_MESH) whose shards of the points are
a power of two, each column is committed by `sharded.msm_sharded`.
"""

from __future__ import annotations

import torch

from ..fieldmath import limbs, curve
from ..fieldmath.spec import bn254_fr, NWORDS
from ..kernels import msm as msmmod
from ..kernels import ntt as nttmod
from ..parallel import sharded
from .srs import SRS

FR = bn254_fr()


def _mesh_for(m: int):
    """The active mesh if m points split into power-of-two shards on it,
    else None (`ezkl_tpu/plonk/kzg.py:_commit`)."""
    mesh = sharded.active_mesh()
    if mesh is None:
        return None
    d = len(mesh)
    local = m // d if m % d == 0 else 0
    return mesh if local >= 1 and (local & (local - 1)) == 0 else None


def _commit_points(srs: SRS, vals: torch.Tensor, lagrange: bool) -> curve.PointP:
    """vals (C, 8, m) Montgomery -> (C,) projective commitments: one batched
    MSM, or under a mesh one sharded MSM per column."""
    m = vals.shape[-1]
    assert m <= srs.n, "poly too long for SRS"
    pts = srs.g1.map(lambda a: a[..., :m])
    v = vals.movedim(0, 1)                    # (8, C, m) transform batch layout
    if lagrange:
        v = nttmod.intt(FR, v)
    raw = limbs.from_mont(FR, v)
    mesh = _mesh_for(m)
    if mesh is not None:
        cols = [sharded.msm_sharded(mesh, pts, raw[:, i], affine=True).map(
            lambda a: a.to(vals.device)) for i in range(raw.shape[1])]
        return curve.PointP(*(torch.stack([p[j] for p in cols], dim=-1) for j in range(3)))
    return msmmod.msm_multi(pts, raw.movedim(1, 0), c=msmmod.default_window_bits(m), affine=True)


def commit_coeff(srs: SRS, coeffs: torch.Tensor) -> curve.PointP:
    """Commitment to a coefficient-form poly (8, m), m <= srs.n."""
    return _commit_points(srs, coeffs[None], False).map(lambda a: a[..., 0])


def commit_lagrange(srs: SRS, evals: torch.Tensor) -> curve.PointP:
    """Commitment to a poly given by its evals over H (|H| = len)."""
    return _commit_points(srs, evals[None], True).map(lambda a: a[..., 0])


def commit_many(srs: SRS, stacks, lagrange: bool = True) -> list:
    """Commit C same-length polys in ONE batched MSM.

    stacks: (C, 8, m) tensor or a list of (8, m) tensors. Returns a list of C
    host affine points (transcript-ready), in order. C is padded to a power
    of two with zero polys, as in the JAX package (`kzg.py:140-143`), except
    under a mesh, which commits column by column."""
    if isinstance(stacks, (list, tuple)):
        if not stacks:
            return []
        stacks = torch.stack(list(stacks), dim=0)
    C = stacks.shape[0]
    if C == 0:
        return []
    Cp = 1 << (C - 1).bit_length()
    if Cp != C and _mesh_for(stacks.shape[-1]) is None:
        stacks = torch.cat([stacks, torch.zeros((Cp - C,) + stacks.shape[1:],
                                                dtype=stacks.dtype, device=stacks.device)])
    out = _commit_points(srs, stacks, lagrange)
    return curve.decode_points(out.map(lambda a: a[..., :C]))


def _sum_last(v: torch.Tensor) -> torch.Tensor:
    """Field sum along the last axis (log-depth halving)."""
    n = v.shape[-1]
    while n > 1:
        if n % 2:
            v = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
            n += 1
        v = limbs.add(FR, v[..., : n // 2], v[..., n // 2:])
        n //= 2
    return v[..., 0]


def _omega_powers(k: int, device) -> torch.Tensor:
    return limbs.powers(FR, nttmod.root_of_unity(FR, k), 1 << k, device)


def eval_at(evals: torch.Tensor, z: int, k: int) -> torch.Tensor:
    """Barycentric evaluation p(z) from evals over H (z not in H):
    p(z) = (z^n - 1)/n * sum_i evals_i * w^i / (z - w^i). Returns an (8,)
    Montgomery scalar."""
    p, n, dev = FR.modulus, 1 << k, evals.device
    wi = _omega_powers(k, dev)
    zb = limbs.const(FR, z, device=dev)[:, None].expand(NWORDS, n)
    inv = limbs.batch_inv(FR, limbs.sub(FR, zb, wi))
    terms = limbs.mont_mul(FR, limbs.mont_mul(FR, evals, wi), inv)
    scale = limbs.const(FR, (pow(z, n, p) - 1) * pow(n, -1, p) % p, device=dev)
    return limbs.mont_mul(FR, _sum_last(terms), scale)


def eval_coeff_at(coeffs: torch.Tensor, z: int, k: int) -> torch.Tensor:
    """p(z) from coefficient form (8, n) at host point z -> (8,) mont."""
    pw = limbs.powers_dynamic(FR, limbs.const(FR, z, device=coeffs.device), coeffs.shape[-1])
    return _sum_last(limbs.mont_mul(FR, coeffs, pw))


def open_witness_evals(evals: torch.Tensor, value, z: int, k: int) -> torch.Tensor:
    """(p - v)/(X - z) as evals over H. `value` is the (8,) Montgomery p(z)."""
    n, dev = 1 << k, evals.device
    wi = _omega_powers(k, dev)
    zb = limbs.const(FR, z, device=dev)[:, None].expand(NWORDS, n)
    inv = limbs.batch_inv(FR, limbs.sub(FR, wi, zb))
    return limbs.mont_mul(FR, limbs.sub(FR, evals, value[:, None]), inv)

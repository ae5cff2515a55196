"""Radix-2 NTT / coset NTT over BN254 Fr (port of `ezkl_tpu/kernels/ntt.py`).

Data layout `(8, *batch, n)` Montgomery limbs; one bit-reversal gather, then
the log2(n) butterfly stages in `pntt.pass_split(log2 n)` passes of up to 10
stages, each pass one launch of K2 (`pntt.stages`) over the whole array, on
either device. The JAX package's four-step branch (`ntt.py:163-172`) was a
TPU layout choice and is not ported. The one twiddle table of a size and
direction, [w^0 .. w^(n/2 - 1)], is built on the device once per (field,
size, direction, device) by `limbs.powers`; every stage reads its twiddles
from it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fieldmath import limbs
from ..fieldmath.spec import FieldSpec
from . import pntt


def root_of_unity(spec: FieldSpec, k: int, inverse: bool = False) -> int:
    """Primitive 2^k-th root of unity in the field (as a Python int)."""
    assert k <= spec.two_adicity, f"domain 2^{k} exceeds field 2-adicity"
    w = pow(spec.root_of_unity, 1 << (spec.two_adicity - k), spec.modulus)
    if inverse:
        w = pow(w, -1, spec.modulus)
    return w


_DEV_MEMO: dict = {}


def dev_cached(key, make) -> torch.Tensor:
    """Device copy of a host table, made once per key (the key names the
    device)."""
    hit = _DEV_MEMO.get(key)
    if hit is None:
        hit = _DEV_MEMO[key] = make()
    return hit


def twiddles(spec: FieldSpec, k: int, inverse: bool, device) -> torch.Tensor:
    """The master table [w^0 .. w^(2^(k-1) - 1)] on `device`, (8, 2^(k-1))."""
    return dev_cached(("tw", spec, k, inverse, str(device)),
                      lambda: limbs.powers(spec, root_of_unity(spec, k, inverse),
                                           max((1 << k) // 2, 1), device))


@functools.lru_cache(maxsize=64)
def _bitrev_perm(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _bitrev(k: int, device) -> torch.Tensor:
    return dev_cached(("bitrev", k, str(device)),
                      lambda: torch.from_numpy(_bitrev_perm(k)).to(device))


def ntt(spec: FieldSpec, coeffs: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order radix-2 NTT along the last axis of (8, *batch, n) Montgomery
    limbs; n a power of two. Inverse includes the 1/n scaling."""
    n = coeffs.shape[-1]
    k = int(n).bit_length() - 1
    assert (1 << k) == n, "n must be a power of two"
    if n == 1:
        return coeffs
    x = coeffs[..., _bitrev(k, coeffs.device)]
    tw = twiddles(spec, k, inverse, coeffs.device)
    for s0, r in pntt.pass_split(k):
        x = pntt.stages(spec, x, tw, k, s0, r)
    if inverse:
        ninv = limbs.const(spec, pow(n, -1, spec.modulus), device=x.device)
        x = limbs.mont_mul(spec, x, ninv.reshape((-1,) + (1,) * (x.dim() - 1)))
    return x


def intt(spec: FieldSpec, evals: torch.Tensor) -> torch.Tensor:
    return ntt(spec, evals, inverse=True)


def _coset_powers(spec: FieldSpec, n: int, inverse: bool, device) -> torch.Tensor:
    """[g^0, .., g^(n-1)] for the coset generator g (the field's
    multiplicative generator) as (8, n) Montgomery limbs."""
    g = spec.generator if not inverse else pow(spec.generator, -1, spec.modulus)
    return dev_cached(("coset", spec, n, inverse, str(device)),
                      lambda: limbs.powers(spec, g, n, device))


def coset_ntt(spec: FieldSpec, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate over the coset g*H: scale coeff j by g^j, then NTT."""
    gp = _coset_powers(spec, coeffs.shape[-1], False, coeffs.device)
    gp = gp.reshape((gp.shape[0],) + (1,) * (coeffs.dim() - 2) + (gp.shape[-1],))
    return ntt(spec, limbs.mont_mul(spec, coeffs, gp))


def coset_intt(spec: FieldSpec, evals: torch.Tensor) -> torch.Tensor:
    """Inverse of `coset_ntt`."""
    coeffs = intt(spec, evals)
    gp = _coset_powers(spec, evals.shape[-1], True, evals.device)
    gp = gp.reshape((gp.shape[0],) + (1,) * (evals.dim() - 2) + (gp.shape[-1],))
    return limbs.mont_mul(spec, coeffs, gp)


def host_ntt(spec: FieldSpec, values: list[int], inverse: bool = False) -> list[int]:
    """O(n^2) bigint DFT for tests."""
    n = len(values)
    k = n.bit_length() - 1
    w = root_of_unity(spec, k, inverse)
    p = spec.modulus
    out = [sum(v * pow(w, i * j, p) for j, v in enumerate(values)) % p for i in range(n)]
    if inverse:
        ninv = pow(n, -1, p)
        out = [(v * ninv) % p for v in out]
    return out

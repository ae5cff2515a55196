"""Carry the JAX package's arrays across to the port, and back.

The JAX package stores field arrays as (16, *batch) uint32 16-bit limbs; the
port as (8, *batch) int32 32-bit limbs. Both hold the same Montgomery (or raw)
integers, so the conversion is exact: word i = limb 2i | limb 2i+1 << 16.

Everything here reads numpy arrays (anything `np.asarray` accepts) and plain
Python values by attribute; nothing imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .fieldmath import limbs
from .fieldmath.curve import PointP
from .plonk.assign import Assignment
from .plonk.cs import Column
from .plonk.keygen import ProvingKey, VerifyingKey
from .plonk.domain import domain as make_domain
from .plonk.srs import SRS


def words_from_ref(a) -> np.ndarray:
    """(16, *B) uint32 16-bit limbs -> (8, *B) uint32 words (host)."""
    a = np.asarray(a, dtype=np.uint32)
    return a[0::2] | (a[1::2] << np.uint32(16))


def limbs_from_ref(a, device=None) -> torch.Tensor:
    """(16, *B) uint32 -> (8, *B) int32 tensor on `device`."""
    return limbs.to_device(words_from_ref(a), device)


def limbs_to_ref(w) -> np.ndarray:
    """(8, *B) words (tensor or host array) -> (16, *B) uint32 16-bit limbs."""
    w = limbs.host_words(w)
    out = np.stack([w & np.uint32(0xFFFF), w >> np.uint32(16)], axis=1)
    return out.reshape((16,) + w.shape[1:])


def _stack_words(a) -> np.ndarray:
    """(C, 16, n) column stack -> (C, 8, n) uint32 words (host)."""
    a = np.asarray(a, dtype=np.uint32)
    return np.ascontiguousarray(a[:, 0::2] | (a[:, 1::2] << np.uint32(16)))


def stack_from_ref(a, device=None) -> torch.Tensor:
    """(C, 16, n) column stack -> (C, 8, n) int32 tensor on `device`."""
    return limbs.to_device(_stack_words(a), device)


def stack_to_ref(t) -> np.ndarray:
    """(C, 8, n) column stack (tensor or host array) -> (C, 16, n) uint32."""
    w = np.moveaxis(limbs.host_words(t), 1, 0)                 # (8, C, n)
    return np.ascontiguousarray(np.moveaxis(limbs_to_ref(w), 0, 1))


def points_from_ref(p, device=None) -> PointP:
    """Projective point with (16, *B) coordinates .x, .y, .z -> PointP."""
    return PointP(*(limbs_from_ref(c, device) for c in (p.x, p.y, p.z)))


def srs_from_ref(ref, device=None) -> SRS:
    """Object with .k, .g1 (.x/.y/.z), .g2, .s_g2 -> port SRS."""
    return SRS(k=int(ref.k), g1=points_from_ref(ref.g1, device),
               g2=ref.g2, s_g2=ref.s_g2)


def _column(col) -> Column:
    return Column(str(col.kind), int(col.index))


def assignment_from_ref(ref, cs) -> Assignment:
    """Reference Assignment (by attribute) -> port Assignment over the port
    constraint system `cs` built the same way."""
    copies = [(_column(ca), np.asarray(ra, np.int64), _column(cb), np.asarray(rb, np.int64))
              for ca, ra, cb, rb in ref.copies]
    return Assignment(cs=cs, k=int(ref.k), fixed=_stack_words(ref.fixed),
                      advice=_stack_words(ref.advice),
                      instance=[[int(v) for v in col] for col in ref.instance],
                      copies=copies)


def pk_from_ref(ref, cs, device=None) -> ProvingKey:
    """Reference ProvingKey (by attribute) -> port ProvingKey over `cs`."""
    vk = ref.vk
    dom = make_domain(int(vk.k), gate_degree=max(cs.max_gate_degree(), 2))
    port_vk = VerifyingKey(cs=cs, k=int(vk.k), domain=dom,
                           fixed_commitments=list(vk.fixed_commitments),
                           sigma_commitments=list(vk.sigma_commitments))
    return ProvingKey(vk=port_vk,
                      fixed_lagrange=stack_from_ref(ref.fixed_lagrange, device),
                      sigma_lagrange=stack_from_ref(ref.sigma_lagrange, device),
                      perm_maps=np.asarray(ref.perm_maps))

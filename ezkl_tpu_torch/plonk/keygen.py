"""Key generation: fixed/sigma commitments + permutation construction
(port of `ezkl_tpu/plonk/keygen.py`).

The permutation uses the cycle construction over (column, row) pairs, with
sigma evaluation arrays built on the device by a gather + one mont_mul over
delta^j / omega^i tables.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..fieldmath import limbs
from ..fieldmath.spec import bn254_fr
from ..kernels import ntt as nttmod
from . import kzg
from .assign import Assignment
from .cs import ConstraintSystem, FIXED
from .domain import Domain, domain as make_domain
from .srs import SRS

FR = bn254_fr()

# delta: generator of the odd-order subgroup -> distinct cosets delta^j * H
DELTA = pow(FR.generator, 1 << FR.two_adicity, FR.modulus)


def build_permutation_maps(cs: ConstraintSystem, k: int, copies) -> np.ndarray:
    """-> int32 (m, n, 2): sigma as (column_chunk_index j', row i') per cell.

    Equality classes are computed as connected components of the copy graph
    (union-find semantics — immune to the classic swap-trick's same-cycle
    splitting hazard), then each class becomes one sigma cycle. Fully
    vectorized: copies arrive as whole index-array batches
    (`graph/layout.py:copy_rows`), components via scipy csgraph, cycle
    next-pointers by a per-segment roll. Replaces halo2's per-cell
    permutation Assembly (reference `src/pfsys/mod.rs:376-400` keygen path).
    """
    n = 1 << k
    col_of = {c: j for j, c in enumerate(cs.perm_columns)}
    m = len(cs.perm_columns)
    maps = np.zeros((m, n, 2), dtype=np.int32)
    maps[..., 0] = np.arange(m, dtype=np.int32)[:, None]
    maps[..., 1] = np.arange(n, dtype=np.int32)[None, :]
    if not copies:
        return maps

    ea, eb = [], []
    for ca, ra, cb, rb in copies:
        ea.append(np.asarray(ra, np.int64) + col_of[ca] * n)
        eb.append(np.asarray(rb, np.int64) + col_of[cb] * n)
    a = np.concatenate(ea)
    b = np.concatenate(eb)
    keep = a != b
    a, b = a[keep], b[keep]
    if a.size == 0:
        return maps

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    cells = np.unique(np.concatenate([a, b]))      # sorted linear ids j*n+i
    ia = np.searchsorted(cells, a)
    ib = np.searchsorted(cells, b)
    g = coo_matrix((np.ones(ia.size, np.int8), (ia, ib)),
                   shape=(cells.size, cells.size))
    _, labels = connected_components(g, directed=False)

    order = np.argsort(labels, kind="stable")
    sc = cells[order]                               # cells grouped by class
    sl = labels[order]
    nxt = np.roll(sc, -1)
    starts = np.flatnonzero(np.r_[True, sl[1:] != sl[:-1]])
    ends = np.r_[starts[1:], sl.size] - 1
    nxt[ends] = sc[starts]                          # close each cycle

    maps[sc // n, sc % n, 0] = (nxt // n).astype(np.int32)
    maps[sc // n, sc % n, 1] = (nxt % n).astype(np.int32)
    return maps


def sigma_evals(maps: np.ndarray, k: int, device=None) -> torch.Tensor:
    """(m, 8, n) Montgomery lagrange evals of the sigma polys:
    sigma_j(w^i) = delta^{j'} * w^{i'}."""
    m, n, _ = maps.shape
    wpow = limbs.powers(FR, nttmod.root_of_unity(FR, k), n, device)       # (8, n)
    dpow = limbs.powers(FR, DELTA, max(m, 1), device)                     # (8, m)
    jmap = torch.from_numpy(maps[..., 0].astype(np.int64)).to(wpow.device)
    imap = torch.from_numpy(maps[..., 1].astype(np.int64)).to(wpow.device)
    return limbs.mont_mul(FR, dpow[:, jmap], wpow[:, imap]).movedim(0, 1)


@dataclasses.dataclass
class VerifyingKey:
    cs: ConstraintSystem
    k: int
    domain: Domain
    fixed_commitments: list          # host affine points
    sigma_commitments: list          # host affine points

    def transcript_repr(self) -> bytes:
        h = hashlib.blake2b(digest_size=32)
        h.update(f"k={self.k};nf={self.cs.num_fixed};na={self.cs.num_advice};"
                 f"ni={self.cs.num_instance};g={len(self.cs.gates)};"
                 f"lk={len(self.cs.lookups)};sh={len(self.cs.shuffles)}".encode())
        for pt in self.fixed_commitments + self.sigma_commitments:
            if pt is None:
                h.update(b"\x00" * 64)
            else:
                h.update(int(pt[0]).to_bytes(32, "little"))
                h.update(int(pt[1]).to_bytes(32, "little"))
        return h.digest()


@dataclasses.dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_lagrange: torch.Tensor     # (nf, 8, n) mont
    sigma_lagrange: torch.Tensor     # (m, 8, n) mont
    perm_maps: np.ndarray

    @property
    def device(self):
        return self.fixed_lagrange.device


def keygen(cs: ConstraintSystem, k: int, srs: SRS,
           fixed_assignment: Assignment, device=None) -> ProvingKey:
    """Build pk/vk from the circuit's fixed columns + collected copies."""
    dev = limbs.device_of(device)
    dom = make_domain(k, gate_degree=max(cs.max_gate_degree(), 2))
    fixed_l = fixed_assignment.device_columns(FIXED, dev)               # (nf, 8, n)

    maps = build_permutation_maps(cs, k, fixed_assignment.copies)
    sig_l = sigma_evals(maps, k, dev)                                   # (m, 8, n)

    fixed_comms = kzg.commit_many(srs, fixed_l) if cs.num_fixed else []
    sigma_comms = kzg.commit_many(srs, sig_l) if len(cs.perm_columns) else []
    vk = VerifyingKey(cs=cs, k=k, domain=dom,
                      fixed_commitments=fixed_comms,
                      sigma_commitments=sigma_comms)
    return ProvingKey(vk=vk, fixed_lagrange=fixed_l,
                      sigma_lagrange=sig_l, perm_maps=maps)

"""MockProver: direct satisfiability checking without cryptography (port of
`ezkl_tpu/plonk/mock.py`).

Evaluates every gate over the whole domain at once (on the device: its
products are K1 launches on the card), and checks copies and lookups by
value on the host. The failure lists equal the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fieldmath import limbs
from ..fieldmath.spec import bn254_fr, NWORDS
from .assign import Assignment
from . import cs as csmod
from .cs import FIXED, ADVICE, INSTANCE
from .evaluator import ChunkCtx, EvalCtx, evaluate

FR = bn254_fr()

# row-chunk size for gate checking on large domains (memory O(chunk))
_GATE_CHUNK = 1 << 17


@dataclasses.dataclass
class Failure:
    kind: str        # "gate" | "copy" | "lookup" | "shuffle"
    name: str
    rows: list[int]

    def __repr__(self):
        head = f"{self.kind} '{self.name}' violated at rows {self.rows[:8]}"
        return head + ("..." if len(self.rows) > 8 else "")


def _nonzero_rows(v) -> np.ndarray:
    return np.nonzero((~limbs.is_zero(v)).cpu().numpy())[0]


def verify(asg: Assignment, challenges: dict | None = None, device=None) -> list[Failure]:
    """Returns a list of failures (empty = satisfied). Gates evaluate on
    `device` (None: the card)."""
    cs = asg.cs
    dev = limbs.device_of(device)
    failures: list[Failure] = []

    cols = {
        FIXED: asg.device_columns(FIXED, dev),
        ADVICE: asg.device_columns(ADVICE, dev),
        INSTANCE: asg.instance_device(dev),
    }
    ch = {i: limbs.const(FR, v, device=dev) for i, v in (challenges or {}).items()}
    ctx = EvalCtx(columns=cols, rot_step=1, challenges=ch)

    # gates must vanish everywhere; above _GATE_CHUNK rows, in row chunks
    # (wraparound gathers for rotations)
    n = asg.n
    if n <= _GATE_CHUNK:
        for g in cs.gates:
            rows = _nonzero_rows(evaluate(g.poly, ctx))
            if rows.size:
                failures.append(Failure("gate", g.name, rows.tolist()))
    else:
        bad: dict[str, list] = {}
        for s in range(0, n, _GATE_CHUNK):
            cctx = ChunkCtx(columns=cols, rot_step=1, challenges=ch,
                            start=s, size=_GATE_CHUNK, n=n)
            for g in cs.gates:
                rows = _nonzero_rows(evaluate(g.poly, cctx))
                if rows.size:
                    bad.setdefault(g.name, []).extend((rows + s).tolist())
        for g in cs.gates:
            if g.name in bad:
                failures.append(Failure("gate", g.name, bad[g.name]))

    # copy constraints by value -- whole index-array batches at once
    raw_of = _raw_columns(asg)
    for a, ra, b, rb in asg.copies:
        va = raw_of(a)[:, ra]                      # (8, K) raw words
        vb = raw_of(b)[:, rb]
        bad = np.flatnonzero(~np.all(va == vb, axis=0))
        for i in bad[:16]:
            failures.append(Failure(
                "copy", f"{a}@{int(ra[i])} == {b}@{int(rb[i])}",
                [int(ra[i]), int(rb[i])]))

    # lookups by value: pack (tuple of field elements) per row into
    # structured u64 rows, then one vectorized sorted-membership test
    for lk in cs.lookups:
        t_pack = np.sort(limbs.pack_rows_multi(
            [_raw_evals(e, ctx) for e in lk.table]))
        bad_rows = []
        for tup in lk.inputs:
            f_pack = limbs.pack_rows_multi([_raw_evals(e, ctx) for e in tup])
            pos = np.searchsorted(t_pack, f_pack)
            pos_c = np.minimum(pos, t_pack.size - 1)
            ok = t_pack[pos_c] == f_pack
            bad_rows.extend(np.flatnonzero(~ok).tolist())
        if bad_rows:
            failures.append(Failure("lookup", lk.name, bad_rows))

    # shuffles: multiset equality of compressed tuples over active rows
    # (rows >= last_active_row are reserved for closing/blinding and hold
    # zeros on both sides at layout time)
    act = csmod.last_active_row(asg.n)
    for sh in cs.shuffles:
        a_pack = limbs.pack_rows_multi(
            [_raw_evals(e, ctx)[:, :act] for e in sh.input])
        b_pack = limbs.pack_rows_multi(
            [_raw_evals(e, ctx)[:, :act] for e in sh.table])
        if not np.array_equal(np.sort(a_pack), np.sort(b_pack)):
            bad = np.flatnonzero(np.sort(a_pack) != np.sort(b_pack))
            failures.append(Failure("shuffle", sh.name, bad.tolist()[:16]))

    return failures


def _raw_columns(asg: Assignment):
    """Returns col -> (8, n) RAW word array (instances padded with zeros)."""
    inst = np.zeros((asg.cs.num_instance, NWORDS, asg.n), np.uint32)
    for i, vals in enumerate(asg.instance):
        if vals:
            inst[i][:, :len(vals)] = limbs.encode(FR, vals, mont=False)

    def get(col):
        if col.kind == INSTANCE:
            return inst[col.index]
        return (asg.fixed if col.kind == FIXED else asg.advice)[col.index]

    return get


def _raw_evals(expr, ctx) -> np.ndarray:
    """Evaluate an expression over the domain -> (8, n) RAW words (host)."""
    return limbs.host_words(limbs.from_mont(FR, evaluate(expr, ctx)))

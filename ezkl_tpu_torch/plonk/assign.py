"""Circuit assignments: concrete column values + copy constraints (port of
`ezkl_tpu/plonk/assign.py`).

Columns are held host-side as numpy (num_cols, 8, n) RAW (non-Montgomery)
uint32 words and converted to device Montgomery form in one batch at proving
time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fieldmath import limbs
from ..fieldmath.spec import bn254_fr, NWORDS
from .cs import ConstraintSystem, Column, FIXED, ADVICE, INSTANCE

FR = bn254_fr()


def to_mont_stack(raw: np.ndarray, device=None) -> torch.Tensor:
    """(C, 8, n) host raw words -> (C, 8, n) Montgomery limbs on `device`."""
    t = limbs.to_device(raw, device).movedim(1, 0)
    return limbs.to_mont(FR, t).movedim(0, 1).contiguous()


@dataclasses.dataclass
class Assignment:
    cs: ConstraintSystem
    k: int
    fixed: np.ndarray            # (num_fixed, 8, n) raw words
    advice: np.ndarray           # (num_advice, 8, n) raw words
    instance: list[list[int]]    # host ints per instance column
    copies: list[tuple]          # batches (col_a, rows_a[np], col_b, rows_b[np])
    # phase-1 witness callback: challenges {idx: int} ->
    #   {advice_col_index: list[int] field values (length n)}
    phase_callback: object = None

    @classmethod
    def empty(cls, cs: ConstraintSystem, k: int) -> "Assignment":
        n = 1 << k
        return cls(
            cs=cs,
            k=k,
            fixed=np.zeros((cs.num_fixed, NWORDS, n), np.uint32),
            advice=np.zeros((cs.num_advice, NWORDS, n), np.uint32),
            instance=[[] for _ in range(cs.num_instance)],
            copies=[],
        )

    @property
    def n(self) -> int:
        return 1 << self.k

    # -- writes -------------------------------------------------------------

    def _store(self, col: Column):
        return self.fixed if col.kind == FIXED else self.advice

    def set_ints(self, col: Column, row0: int, values):
        """Assign Python ints (any magnitude) starting at row0."""
        arr = limbs.encode(FR, [v % FR.modulus for v in values], mont=False)
        self._store(col)[col.index][:, row0:row0 + arr.shape[1]] = arr

    def set_i64(self, col: Column, row0: int, values: np.ndarray):
        """Assign an int64 ndarray (fast path)."""
        arr = limbs.encode_i64(FR, values)
        self._store(col)[col.index][:, row0:row0 + arr.shape[-1]] = arr

    def set_ints_at(self, col: Column, rows: list[int], values):
        """Assign Python ints at scattered rows."""
        arr = limbs.encode(FR, [v % FR.modulus for v in values], mont=False)
        self._store(col)[col.index][:, rows] = arr

    def apply_phase1(self, challenges: dict[int, int]):
        """Fill phase-1 advice columns via the witness callback."""
        if self.phase_callback is None:
            return
        cols = self.phase_callback(challenges)
        for idx, values in cols.items():
            self.set_ints(Column(ADVICE, idx), 0, values)

    def set_instance(self, col: Column, values):
        assert col.kind == INSTANCE
        self.instance[col.index] = [int(v) % FR.modulus for v in values]

    def copy(self, a: Column, arow: int, b: Column, brow: int):
        self.copies.append((a, np.asarray([arow], np.int64),
                            b, np.asarray([brow], np.int64)))

    # -- reads (host ints, for debugging / instance prep) ---------------------

    def get_int(self, col: Column, row: int) -> int:
        if col.kind == INSTANCE:
            vals = self.instance[col.index]
            return vals[row] if row < len(vals) else 0
        a = self._store(col)[col.index][:, row:row + 1]
        return int(limbs.decode(FR, a, mont=False)[0])

    # -- device conversion --------------------------------------------------

    def device_columns(self, which: str, device=None) -> torch.Tensor:
        """(num_cols, 8, n) Montgomery lagrange evals on `device`."""
        raw = {FIXED: self.fixed, ADVICE: self.advice}[which]
        return to_mont_stack(raw, device)

    def instance_device(self, device=None) -> torch.Tensor:
        """(num_instance, 8, n) Montgomery (zero-padded) on `device`."""
        out = np.zeros((self.cs.num_instance, NWORDS, self.n), np.uint32)
        for i, vals in enumerate(self.instance):
            if vals:
                out[i][:, :len(vals)] = limbs.encode(FR, vals, mont=False)
        return to_mont_stack(out, device)

"""Base gate configuration + span layout engine.

The span-layout re-design of the reference's `BaseConfig` + `RegionCtx`
(`ezkl/src/circuit/ops/chip.rs:264-448`, `ops/region.rs`):

* Same gate algebra as ezkl's base ops (Add/Sub/Mult, Dot/Sum/CumProd with
  rotation -1 accumulators — `ops/base.rs:28-96`) over THREE advice columns
  (ezkl's ModelVars also allocates 3 advice blocks, `graph/vars.rs:362+`).
* Instead of cell-by-cell assignment, tensors live in contiguous SPANS and
  every write is a vectorized numpy slice; copy constraints are emitted as
  whole index arrays.
* Nonlinearities are logup lookups into per-function tables with a
  selector-gated default row (analog of `table.rs` SelectorConstructor).
* The last BLINDING_FACTORS+1 rows are reserved by the proof system for the
  closing row + zero-knowledge blinding (`plonk/cs.py:last_active_row`).

Port of `ezkl_tpu/graph/layout.py` (pure numpy, copied; imports rewired to the
port's modules).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..plonk import cs as csmod
from ..plonk.assign import Assignment
from ..plonk.cs import ADVICE, FIXED, INSTANCE
from .quantize import check_range

BASE_GATES = ("add", "sub", "mul", "dot_init", "dot", "sum_init", "sum",
              "prod_init", "prod")


class BaseConfig:
    """Creates columns + base gates on a fresh ConstraintSystem."""

    def __init__(self):
        cs = csmod.ConstraintSystem()
        self.cs = cs
        self.a0 = cs.advice_column()
        self.a1 = cs.advice_column()
        self.a2 = cs.advice_column()
        self.c_fixed = cs.fixed_column()         # constants / params (fixed vis)
        self.instance = cs.instance_column()
        for col in (self.a0, self.a1, self.a2, self.c_fixed, self.instance):
            cs.enable_equality(col)

        self.sel = {name: cs.fixed_column() for name in BASE_GATES}
        q = {name: cs.query(self.sel[name]) for name in BASE_GATES}
        v0, v1, v2 = cs.query(self.a0), cs.query(self.a1), cs.query(self.a2)
        v2p = cs.query(self.a2, -1)
        cs.create_gate("add", q["add"] * (v0 + v1 - v2))
        cs.create_gate("sub", q["sub"] * (v0 - v1 - v2))
        cs.create_gate("mul", q["mul"] * (v0 * v1 - v2))
        cs.create_gate("dot_init", q["dot_init"] * (v0 * v1 - v2))
        cs.create_gate("dot", q["dot"] * (v2p + v0 * v1 - v2))
        cs.create_gate("sum_init", q["sum_init"] * (v0 - v2))
        cs.create_gate("sum", q["sum"] * (v2p + v0 - v2))
        cs.create_gate("prod_init", q["prod_init"] * (v0 - v2))
        cs.create_gate("prod", q["prod"] * (v2p * v0 - v2))

        self.tables: dict[str, dict] = {}        # name -> table info
        # dedicated UNBLINDED advice columns whose commitment doubles as a
        # public KZG commitment of the data laid in them (kzgcommit
        # visibility; reference PolyCommitChip, `polycommit.rs:44-107`)
        self.polycommit_cols: list = []

    def polycommit_column(self):
        col = self.cs.advice_column(unblinded=True)
        self.cs.enable_equality(col)
        self.polycommit_cols.append(col)
        return col

    def ensure_table(self, name: str, inputs: np.ndarray, outputs: np.ndarray,
                     cap: int | None = None):
        """Create (or fetch) a lookup table + its logup argument(s).

        inputs/outputs: int64 arrays of table rows. The lookup reads
        (q*a0 + (1-q)*d_in, q*a1 + (1-q)*d_out) from every circuit row.

        Tables larger than `cap` usable rows split into CHUNKS — one
        (t_in, t_out, sel) column triple and one logup argument per chunk,
        the analog of the reference's multi-column table split
        (`ezkl/src/circuit/table.rs:136-204`: `col_size =
        2^k - blinding - 3`, inputs spread over `num_cols` column sets).
        A lookup row activates exactly the selector of the chunk holding
        its input value; for every other chunk it evaluates to that
        chunk's default (first) row.
        """
        if name in self.tables:
            return self.tables[name]
        cs = self.cs
        L = int(inputs.size)
        n_chunks = 1 if cap is None else max(1, -(-L // cap))
        chunk = -(-L // n_chunks)
        chunks = []
        for j in range(n_chunks):
            seg_in = inputs[j * chunk:(j + 1) * chunk]
            seg_out = outputs[j * chunk:(j + 1) * chunk]
            t_in = cs.fixed_column()
            t_out = cs.fixed_column()
            q_col = cs.fixed_column()
            d_in, d_out = int(seg_in[0]), int(seg_out[0])
            q = cs.query(q_col)
            one = csmod.Constant(1)
            e_in = q * cs.query(self.a0) + (one - q) * csmod.Constant(d_in)
            e_out = q * cs.query(self.a1) + (one - q) * csmod.Constant(d_out)
            lk_name = name if n_chunks == 1 else f"{name}#{j}"
            cs.add_lookup(lk_name, [(e_in, e_out)],
                          (cs.query(t_in), cs.query(t_out)))
            chunks.append(dict(t_in=t_in, t_out=t_out, sel=q_col,
                               inputs=seg_in, outputs=seg_out,
                               d_in=d_in, d_out=d_out))
        info = dict(inputs=inputs, outputs=outputs, chunks=chunks,
                    chunk_rows=chunk)
        self.tables[name] = info
        return info


@dataclasses.dataclass
class Span:
    """A tensor's home: a row-index array (row-major element order) in one
    column. Contiguous for plain tensors; strided for accumulator outputs."""

    col: object
    rows: np.ndarray

    @classmethod
    def contiguous(cls, col, row0: int, size: int) -> "Span":
        return cls(col, np.arange(row0, row0 + size))

    @property
    def size(self) -> int:
        return int(self.rows.size)


@dataclasses.dataclass
class TVal:
    """A graph tensor during layout: quantized ints + scale + location.

    `witness=True` marks CLAIMED, input-dependent values (e.g. a division
    quotient, a decomposition digit): they must live in ADVICE — placing
    them in the fixed column would bake one input's witness into keygen
    and break proofs for every other input."""

    ints: np.ndarray          # int64, the tensor's shape
    scale: int
    span: Span | None         # None until materialized in the circuit
    witness: bool = False

    @property
    def shape(self):
        return self.ints.shape


class LayoutCtx:
    """Row-cursor + column-store; produces the final Assignment."""

    def __init__(self, cfg: BaseConfig, k: int):
        self.cfg = cfg
        self.k = k
        self.n = 1 << k
        # rows [usable, n) are the proof system's closing + blinding rows
        self.usable = csmod.last_active_row(self.n)
        self.row = 0
        self._cols: dict[tuple, np.ndarray] = {}
        # full-field values that don't fit int64 (e.g. Poseidon states):
        # {(kind, idx): {row: int}} patched over the int64 arrays at finalize
        self._overlay: dict[tuple, dict[int, int]] = {}
        self.copies: list = []
        self.instance_vals: list[int] = []

    # -- storage ------------------------------------------------------------

    def _arr(self, col) -> np.ndarray:
        key = (col.kind, col.index)
        if key not in self._cols:
            self._cols[key] = np.zeros(self.n, np.int64)
        return self._cols[key]

    def alloc(self, size: int) -> int:
        r = self.row
        if r + size > self.usable:
            raise ValueError(
                f"circuit overflow: need {r + size} rows, usable {self.usable} "
                f"(k={self.k}); raise logrows")
        self.row += size
        return r

    def write(self, col, row0: int, values: np.ndarray):
        v = check_range(np.asarray(values, np.int64).reshape(-1))
        self._arr(col)[row0:row0 + v.size] = v

    def write_field(self, col, row0: int, values: list[int]):
        """Write arbitrary field elements (Python ints) — overlay cells."""
        self._arr(col)  # ensure column exists
        ov = self._overlay.setdefault((col.kind, col.index), {})
        for i, v in enumerate(values):
            ov[row0 + i] = int(v)

    def write_field_at(self, col, rows, values):
        """Bulk overlay write at arbitrary rows: one C-speed dict.update
        instead of a per-cell Python loop (hashed-visibility hot path)."""
        self._arr(col)  # ensure column exists
        ov = self._overlay.setdefault((col.kind, col.index), {})
        if isinstance(rows, np.ndarray):
            rows = rows.tolist()
        ov.update(zip(rows, map(int, values)))

    def enable(self, gate: str, row0: int, size: int):
        self._arr(self.cfg.sel[gate])[row0:row0 + size] = 1

    def copy_rows(self, col_a, rows_a, col_b, rows_b):
        """Emit a batched copy constraint: col_a[rows_a[i]] == col_b[rows_b[i]].

        Stored as whole index arrays (no per-cell Python tuples) — keygen
        consumes them vectorized (`plonk/keygen.py:build_permutation_maps`)."""
        ra = np.asarray(rows_a, np.int64).reshape(-1)
        rb = np.asarray(rows_b, np.int64).reshape(-1)
        assert ra.size == rb.size
        if ra.size:
            self.copies.append((col_a, ra, col_b, rb))

    # -- tensor materialization ----------------------------------------------

    def materialize(self, tv: TVal, col=None) -> Span:
        """Give a spanless tensor a home: constants -> c_fixed, claimed
        witness values (tv.witness) -> an advice column."""
        if tv.span is not None:
            return tv.span
        col = col or (self.cfg.a2 if tv.witness else self.cfg.c_fixed)
        size = int(tv.ints.size)
        r = self.alloc(size)
        self.write(col, r, tv.ints)
        tv.span = Span.contiguous(col, r, size)
        return tv.span

    def stage_polycommit(self, tv: TVal) -> Span:
        """Stage tv's values in a DEDICATED unblinded column at rows
        [0, size): the column's KZG commitment is then a canonical
        commitment of the data alone — independent of where the
        surrounding circuit's row cursor happens to be — so two circuits
        committing the same boundary tensor produce byte-identical
        commitments. That equality is the link proof-splitting relies on
        (reference ProofSplitCommit + swap_proof_commitments,
        `ezkl/src/pfsys/mod.rs:317-373,492-554`)."""
        col = self.cfg.polycommit_column()
        flat = tv.ints.reshape(-1)
        if flat.size > self.usable:
            raise ValueError(
                f"polycommit tensor needs {flat.size} rows, usable "
                f"{self.usable} (k={self.k}); raise logrows")
        self.write(col, 0, flat)
        # the committed tensor bounds the circuit size like any region
        self.row = max(self.row, int(flat.size))
        span = Span.contiguous(col, 0, int(flat.size))
        if tv.span is None:
            tv.span = span                  # home IS the commitment column
        else:
            self.copy_rows(col, span.rows, tv.span.col, tv.span.rows)
        return span

    def stage_operand(self, tv: TVal, col, row0: int, flat_idx: np.ndarray):
        """Write tv's elements (selected by flat_idx into tv.ints.reshape(-1))
        into `col` rows [row0, ...) and constrain equality to tv's home."""
        src = self.materialize(tv)
        vals = tv.ints.reshape(-1)[flat_idx]
        self.write(col, row0, vals)
        self.copy_rows(col, row0 + np.arange(flat_idx.size),
                       src.col, src.rows[flat_idx])
        return vals

    # -- lookup -------------------------------------------------------------

    def apply_lookup(self, name: str, table_in: np.ndarray, table_out: np.ndarray,
                     tv: TVal, out_scale: int) -> TVal:
        """Map tv through the named table: rows with (a0=in, a1=out)."""
        info = self.cfg.ensure_table(name, table_in, table_out,
                                     cap=self.usable)
        x = tv.ints.reshape(-1)
        lo, hi = int(info["inputs"][0]), int(info["inputs"][-1])
        if x.size and (x.min() < lo or x.max() > hi):
            raise ValueError(
                f"lookup '{name}': input range [{x.min()}, {x.max()}] outside "
                f"table [{lo}, {hi}]; raise lookup_range or lower scales")
        # table outputs indexed by (x - lo) assuming contiguous table inputs
        out = info["outputs"][x - lo]
        r = self.alloc(x.size)
        self.stage_operand(tv, self.cfg.a0, r, np.arange(x.size))
        self.write(self.cfg.a1, r, out)
        chunks = info["chunks"]
        if len(chunks) == 1:
            self._arr(chunks[0]["sel"])[r:r + x.size] = 1
        else:
            ci = (x - lo) // info["chunk_rows"]
            for j, ch in enumerate(chunks):
                rows_j = r + np.nonzero(ci == j)[0]
                self._arr(ch["sel"])[rows_j] = 1
        res = TVal(out.reshape(tv.shape), out_scale,
                   Span.contiguous(self.cfg.a1, r, int(x.size)))
        return res

    # -- dynamic lookup (advice-table) ---------------------------------------

    def dynamic_lookup_gather(self, data_tv: TVal, idx_tv: TVal,
                              out_scale: int | None = None) -> TVal:
        """out[i] = data[idx[i]] via a logup argument whose TABLE is witness
        data — the reference's dynamic-lookup argument
        (`ezkl/src/circuit/ops/layouts.rs:1483`,
        `ops/chip.rs:619-714`). Cost is L + N rows instead of the one-hot
        indicator formulation's O(L*N).

        Layout: a table region of L rows holds (pos_j, data_j) —
        pos in a per-call fixed column, values copied into a1 — gated by a
        fixed selector; a lookup region of N rows holds (idx_i, out_i) in
        (a0, a1) gated by another selector. Inactive rows on both sides
        evaluate to the sentinel pair (-1, 0), which only inactive table
        rows produce (real pos >= 0)."""
        cfg = self.cfg
        cs = cfg.cs
        data = data_tv.ints.reshape(-1)
        idx = idx_tv.ints.reshape(-1)
        L, N = int(data.size), int(idx.size)
        if idx.size and (idx.min() < 0 or idx.max() >= L):
            raise ValueError(f"gather index out of range [0, {L})")
        out = data[idx]

        q_t = cs.fixed_column()
        q_in = cs.fixed_column()
        pos_col = cs.fixed_column()

        # table region: (pos, value)
        rt = self.alloc(L)
        self.stage_operand(data_tv, cfg.a1, rt, np.arange(L))
        self._arr(pos_col)[rt:rt + L] = np.arange(L)
        self._arr(q_t)[rt:rt + L] = 1

        # lookup region: (idx, out)
        rin = self.alloc(N)
        self.stage_operand(idx_tv, cfg.a0, rin, np.arange(N))
        self.write(cfg.a1, rin, out)
        self._arr(q_in)[rin:rin + N] = 1

        qi = cs.query(q_in)
        qt = cs.query(q_t)
        one = csmod.Constant(1)
        neg1 = csmod.Constant(-1)
        in_i = qi * cs.query(cfg.a0) + (one - qi) * neg1
        in_o = qi * cs.query(cfg.a1)
        t_i = qt * cs.query(pos_col) + (one - qt) * neg1
        t_o = qt * cs.query(cfg.a1)
        name = f"dyn_gather_{len(cs.lookups)}"
        cs.add_lookup(name, [(in_i, in_o)], (t_i, t_o))

        sc = data_tv.scale if out_scale is None else out_scale
        return TVal(out.reshape(idx_tv.shape), sc,
                    Span.contiguous(cfg.a1, rin, N))

    # -- finalize -----------------------------------------------------------

    def finalize(self) -> Assignment:
        cs = self.cfg.cs
        asg = Assignment.empty(cs, self.k)
        # fill table columns (pad with the chunk default row to the end)
        for name, info in self.cfg.tables.items():
            for ch in info["chunks"]:
                t_in = np.full(self.n, ch["d_in"], np.int64)
                t_out = np.full(self.n, ch["d_out"], np.int64)
                L = ch["inputs"].size
                # the logup argument covers only the active rows
                # [0, usable) (prover multiplicities scan [:a]), so every
                # chunk must fit there — guaranteed by the cap passed to
                # ensure_table; catch the off-by-one here anyway
                assert L <= self.usable, (
                    f"table '{name}' chunk ({L} rows) exceeds {self.usable} "
                    f"usable rows (k={self.k})")
                t_in[:L] = ch["inputs"]
                t_out[:L] = ch["outputs"]
                self._arr(ch["t_in"])[:] = t_in
                self._arr(ch["t_out"])[:] = t_out
        for (kind, idx), arr in self._cols.items():
            col = csmod.Column(kind, idx)
            asg.set_i64(col, 0, arr)
        for (kind, idx), cells in self._overlay.items():
            col = csmod.Column(kind, idx)
            rows = sorted(cells)
            asg.set_ints_at(col, rows, [cells[r] for r in rows])
        asg.set_instance(self.cfg.instance, self.instance_vals)
        asg.copies = self.copies
        fre = getattr(self.cfg, "_freivalds", None)
        if fre is not None:
            asg.phase_callback = fre.make_callback(self.n)
        return asg

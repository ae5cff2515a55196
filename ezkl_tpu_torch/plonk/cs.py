"""PLONKish constraint system: columns, expressions, gates, lookups,
permutation.

This is the in-tree replacement for the halo2 fork's `ConstraintSystem` /
`plonk` module that the reference builds its `BaseConfig` on
(SURVEY.md §2.2, `ezkl/src/circuit/ops/chip.rs:264-282`).
Differences are deliberate simplifications:

* Expressions are a tiny AST evaluated BATCHED over the whole (extended)
  domain with vectorized limb ops — no per-row evaluation ever.
* Lookups use the log-derivative (logup / "mv-lookup") argument — the
  reference enables the fork's `mv-lookup` feature too (`Cargo.toml`).
* The permutation argument is the standard chunked grand-product.
* Selectors are plain fixed columns (no selector compression pass).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

FIXED, ADVICE, INSTANCE = "fixed", "advice", "instance"

# Zero-knowledge blinding: the last BLINDING_FACTORS rows of every advice /
# permutation-Z / lookup-phi polynomial hold fresh randomness, and row
# n - BLINDING_FACTORS - 1 is the closing ("last active") row for the
# running arguments. Usable layout rows are [0, n - BLINDING_FACTORS - 1).
# Mirrors the reference's ASSUMED_BLINDING_FACTORS
# (`ezkl/src/graph/mod.rs:100`) sized to cover each poly's
# opened evaluations plus its commitment.
BLINDING_FACTORS = 6

# Maximum number of chunked column-triples a single lookup table may split
# into (layout.py ensure_table). The analog of the reference's
# MAX_NUM_LOOKUP_COLS (`ezkl/src/graph/mod.rs:79-83`); shared by
# gen_settings sizing (graph/circuit.py) and the table-range guard
# (graph/ops.py) so the two can never disagree.
MAX_LOOKUP_COLS = 12


def last_active_row(n: int) -> int:
    """Index of the closing row `a`: running arguments hold on [0, a),
    boundary constraints bind at a, rows (a, n) are random blinding."""
    return n - BLINDING_FACTORS - 1


@dataclasses.dataclass(frozen=True)
class Column:
    kind: str
    index: int

    def __repr__(self):
        return f"{self.kind}[{self.index}]"


@dataclasses.dataclass(frozen=True)
class Query:
    column: Column
    rotation: int


# ---------------------------------------------------------------------------
# expression AST
# ---------------------------------------------------------------------------

class Expr:
    def __add__(self, other):
        return Sum(self, _wrap(other))

    def __radd__(self, other):
        return Sum(_wrap(other), self)

    def __sub__(self, other):
        return Sum(self, Scaled(_wrap(other), -1))

    def __rsub__(self, other):
        return Sum(_wrap(other), Scaled(self, -1))

    def __mul__(self, other):
        other = _wrap(other)
        return Product(self, other)

    def __rmul__(self, other):
        return Product(_wrap(other), self)

    def __neg__(self):
        return Scaled(self, -1)

    def degree(self) -> int:
        raise NotImplementedError

    def queries(self) -> list[Query]:
        out = []
        self._collect(out)
        return out

    def _collect(self, out):
        pass


def _wrap(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    if isinstance(x, int):
        return Constant(x)
    raise TypeError(f"cannot use {type(x)} in an expression")


@dataclasses.dataclass(frozen=True)
class Constant(Expr):
    value: int

    def degree(self):
        return 0

    def _collect(self, out):
        pass


@dataclasses.dataclass(frozen=True)
class Var(Expr):
    """A column query."""

    query: Query

    def degree(self):
        return 1

    def _collect(self, out):
        out.append(self.query)


@dataclasses.dataclass(frozen=True)
class Challenge(Expr):
    """A Fiat-Shamir challenge available from the given phase onward."""

    index: int
    phase: int = 1

    def degree(self):
        return 0

    def _collect(self, out):
        pass


@dataclasses.dataclass(frozen=True)
class Sum(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def _collect(self, out):
        self.a._collect(out)
        self.b._collect(out)


@dataclasses.dataclass(frozen=True)
class Product(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return self.a.degree() + self.b.degree()

    def _collect(self, out):
        self.a._collect(out)
        self.b._collect(out)


@dataclasses.dataclass(frozen=True)
class Scaled(Expr):
    a: Expr
    k: int

    def degree(self):
        return self.a.degree()

    def _collect(self, out):
        self.a._collect(out)


# ---------------------------------------------------------------------------
# arguments
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Gate:
    name: str
    poly: Expr


@dataclasses.dataclass
class Lookup:
    """logup lookup: compressed inputs must appear in the compressed table.

    inputs: list of tuples of expressions; each tuple is one "row stream"
    looked up into the SAME table (mv-lookup batching: one multiplicity
    poly + one grand-sum poly per Lookup regardless of len(inputs)).
    table: tuple of expressions (usually fixed-column queries).
    """

    name: str
    inputs: list[tuple]
    table: tuple


@dataclasses.dataclass
class Shuffle:
    """Multiset-equality (shuffle) argument: the theta-compressed `input`
    tuples over the active rows are a permutation of the compressed `table`
    tuples. Grand product z_{i+1} = z_i * (A_i + gamma)/(B_i + gamma) with
    z_0 = z_a = 1. Analog of the reference's
    `configure_shuffles` (`ezkl/src/circuit/ops/chip.rs:739-833`,
    consumed by `layouts.rs:1624`)."""

    name: str
    input: tuple   # expressions (A side)
    table: tuple   # expressions (B side)


@dataclasses.dataclass
class ConstraintSystem:
    num_fixed: int = 0
    num_advice: int = 0
    num_instance: int = 0
    advice_phase: list[int] = dataclasses.field(default_factory=list)
    # unblinded advice columns (reference `var.rs:73` new_unblinded_advice):
    # the prover skips ZK blinding rows so the column commitment equals the
    # KZG commitment of the data — the PolyCommit/kzgcommit-visibility
    # mechanism (`ezkl/src/circuit/modules/polycommit.rs:44-107`)
    advice_unblinded: list[bool] = dataclasses.field(default_factory=list)
    gates: list[Gate] = dataclasses.field(default_factory=list)
    lookups: list[Lookup] = dataclasses.field(default_factory=list)
    shuffles: list["Shuffle"] = dataclasses.field(default_factory=list)
    perm_columns: list[Column] = dataclasses.field(default_factory=list)
    num_challenges: int = 0

    # -- construction -------------------------------------------------------

    def fixed_column(self) -> Column:
        self.num_fixed += 1
        return Column(FIXED, self.num_fixed - 1)

    def advice_column(self, phase: int = 0, unblinded: bool = False) -> Column:
        self.num_advice += 1
        self.advice_phase.append(phase)
        self.advice_unblinded.append(unblinded)
        return Column(ADVICE, self.num_advice - 1)

    def instance_column(self) -> Column:
        self.num_instance += 1
        return Column(INSTANCE, self.num_instance - 1)

    def challenge(self) -> Challenge:
        self.num_challenges += 1
        return Challenge(self.num_challenges - 1)

    def query(self, column: Column, rotation: int = 0) -> Var:
        return Var(Query(column, rotation))

    def create_gate(self, name: str, *polys: Expr):
        for i, poly in enumerate(polys):
            self.gates.append(Gate(f"{name}[{i}]" if len(polys) > 1 else name, poly))

    def add_lookup(self, name: str, inputs: list[tuple], table: tuple):
        self.lookups.append(Lookup(name, [tuple(t) for t in inputs], tuple(table)))

    def add_shuffle(self, name: str, input: tuple, table: tuple):
        self.shuffles.append(Shuffle(name, tuple(input), tuple(table)))

    def enable_equality(self, column: Column):
        if column not in self.perm_columns:
            self.perm_columns.append(column)

    # -- introspection ------------------------------------------------------

    def max_gate_degree(self) -> int:
        deg = max((g.poly.degree() for g in self.gates), default=1)
        for lk in self.lookups:
            in_deg = max(
                (max(e.degree() for e in tup) for tup in lk.inputs), default=1
            )
            t_deg = max(e.degree() for e in lk.table)
            # (phi(wX)-phi(X)) * prod(f_k+beta) * (t+beta) + ...
            deg = max(deg, 1 + in_deg * len(lk.inputs) + t_deg, 2 + in_deg * len(lk.inputs))
        for sh in self.shuffles:
            d = max(max(e.degree() for e in sh.input),
                    max(e.degree() for e in sh.table))
            # not_last * (z_w*(B+g) - z*(A+g))
            deg = max(deg, 2 + d)
        if self.perm_columns:
            deg = max(deg, 2 + self.perm_chunk_size())
        return max(deg, 2)

    def perm_chunk_size(self, cap: int = 6) -> int:
        return min(len(self.perm_columns), cap)

    def all_queries(self):
        """Deduped (column, rotation) query list across gates & lookups,
        ordered deterministically."""
        seen = {}
        def add(q):
            key = (q.column.kind, q.column.index, q.rotation)
            if key not in seen:
                seen[key] = q
        for g in self.gates:
            for q in g.poly.queries():
                add(q)
        for lk in self.lookups:
            for tup in lk.inputs:
                for e in tup:
                    for q in e.queries():
                        add(q)
            for e in lk.table:
                for q in e.queries():
                    add(q)
        for sh in self.shuffles:
            for e in tuple(sh.input) + tuple(sh.table):
                for q in e.queries():
                    add(q)
        # every permutation column is opened at rotation 0
        for c in self.perm_columns:
            add(Query(c, 0))
        return [seen[k] for k in sorted(seen)]

"""Batched expression evaluation over a whole domain (port of
`ezkl_tpu/plonk/evaluator.py`): gate and lookup expressions evaluate with
vectorized limb ops over all rows at once."""

from __future__ import annotations

import dataclasses

import torch

from ..fieldmath import limbs
from ..fieldmath.spec import bn254_fr, NWORDS
from .cs import Challenge, Constant, Expr, Product, Scaled, Sum, Var

FR = bn254_fr()


@dataclasses.dataclass
class EvalCtx:
    """Column evaluations over some domain (lagrange or extended coset).

    columns: dict kind -> (num_cols, 8, m) Montgomery tensors.
    rot_step: index shift per unit rotation (1 on H; n_ext/n on the
    extended coset).
    challenges: dict index -> (8,) Montgomery scalar.
    """

    columns: dict
    rot_step: int
    challenges: dict

    def query(self, kind: str, index: int, rotation: int) -> torch.Tensor:
        v = self.columns[kind][index]
        if rotation:
            v = torch.roll(v, -rotation * self.rot_step, dims=-1)
        return v

    @property
    def m(self) -> int:
        return next(iter(self.columns.values())).shape[-1]

    @property
    def device(self):
        return next(iter(self.columns.values())).device


@dataclasses.dataclass
class ChunkCtx:
    """EvalCtx over one row chunk [start, start+size) of a length-n domain.

    Rotations become wraparound gathers into the full columns, so gate
    evaluation memory is O(size), independent of n (the MockProver's path
    for large domains)."""

    columns: dict
    rot_step: int
    challenges: dict
    start: int
    size: int
    n: int

    def query(self, kind: str, index: int, rotation: int) -> torch.Tensor:
        v = self.columns[kind][index]
        idx = (self.start + torch.arange(self.size, device=v.device)
               + rotation * self.rot_step) % self.n
        return v.index_select(-1, idx)

    @property
    def m(self) -> int:
        return self.size

    @property
    def device(self):
        return next(iter(self.columns.values())).device


def evaluate(expr: Expr, ctx: EvalCtx) -> torch.Tensor:
    """-> (8, m) Montgomery evals of the expression over the domain."""
    if isinstance(expr, Constant):
        return limbs.bcast_const(FR, expr.value, 1, device=ctx.device).expand(NWORDS, ctx.m)
    if isinstance(expr, Var):
        q = expr.query
        return ctx.query(q.column.kind, q.column.index, q.rotation)
    if isinstance(expr, Challenge):
        return ctx.challenges[expr.index][:, None].expand(NWORDS, ctx.m)
    if isinstance(expr, Sum):
        return limbs.add(FR, evaluate(expr.a, ctx), evaluate(expr.b, ctx))
    if isinstance(expr, Product):
        return limbs.mont_mul(FR, evaluate(expr.a, ctx), evaluate(expr.b, ctx))
    if isinstance(expr, Scaled):
        a = evaluate(expr.a, ctx)
        k = expr.k % FR.modulus
        if k == FR.modulus - 1:
            return limbs.neg(FR, a)
        return limbs.mont_mul(FR, a, limbs.bcast_const(FR, k, 1, device=a.device))
    raise TypeError(f"unknown expr node {type(expr)}")


def evaluate_at_point(expr: Expr, query_values: dict, challenges: dict) -> int:
    """Host bigint evaluation given query values (the verifier's path).

    query_values: dict (kind, index, rotation) -> int.
    """
    p = FR.modulus
    if isinstance(expr, Constant):
        return expr.value % p
    if isinstance(expr, Var):
        q = expr.query
        return query_values[(q.column.kind, q.column.index, q.rotation)] % p
    if isinstance(expr, Challenge):
        return challenges[expr.index] % p
    if isinstance(expr, Sum):
        return (evaluate_at_point(expr.a, query_values, challenges)
                + evaluate_at_point(expr.b, query_values, challenges)) % p
    if isinstance(expr, Product):
        return (evaluate_at_point(expr.a, query_values, challenges)
                * evaluate_at_point(expr.b, query_values, challenges)) % p
    if isinstance(expr, Scaled):
        return (evaluate_at_point(expr.a, query_values, challenges) * expr.k) % p
    raise TypeError(f"unknown expr node {type(expr)}")

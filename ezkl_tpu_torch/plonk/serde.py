"""Stable, safe (no-pickle) serialization for keys and constraint systems
(port of `ezkl_tpu/plonk/serde.py`, in its on-disk layout: a vk.key or
pk.key written by either package loads in the other).

The reference serializes vk/pk in versioned `raw-bytes`/`processed` formats
(`ezkl/src/pfsys/mod.rs:593-670`, env `EZKL_KEY_FORMAT`
`src/lib.rs:172-181`). This is the TPU build's analog:

* vk.key — JSON: constraint-system spec + commitments (hex) + k.
* pk.key — npz (allow_pickle=False): the vk JSON as a uint8 blob plus the
  big witness-side arrays (fixed/sigma Lagrange limbs, permutation maps).
  The Lagrange columns are stored as the JAX package's (C, 16, n) u32
  16-bit Montgomery limbs and converted to and from the port's (C, 8, n)
  words at the boundary (`convert.py`).

Loading never executes arbitrary code (a pickle format would be an
arbitrary-code-execution hazard on `verify`).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from . import cs as csmod
from .cs import (ConstraintSystem, Column, Query, Var, Constant, Challenge,
                 Sum, Product, Scaled, Gate, Lookup, Shuffle)
from .domain import domain as make_domain
from .keygen import ProvingKey, VerifyingKey

FORMAT_VERSION = 2


# ---------------------------------------------------------------------------
# expression codec (compact JSON lists)
# ---------------------------------------------------------------------------

def expr_to_obj(e):
    if isinstance(e, Constant):
        return ["c", hex(e.value)]
    if isinstance(e, Var):
        q = e.query
        return ["q", q.column.kind, q.column.index, q.rotation]
    if isinstance(e, Challenge):
        return ["ch", e.index, e.phase]
    if isinstance(e, Sum):
        return ["+", expr_to_obj(e.a), expr_to_obj(e.b)]
    if isinstance(e, Product):
        return ["*", expr_to_obj(e.a), expr_to_obj(e.b)]
    if isinstance(e, Scaled):
        return ["s", expr_to_obj(e.a), hex(e.k)]
    raise TypeError(f"unknown expression node {type(e)}")


def expr_from_obj(o):
    tag = o[0]
    if tag == "c":
        return Constant(int(o[1], 16))
    if tag == "q":
        return Var(Query(Column(o[1], o[2]), o[3]))
    if tag == "ch":
        return Challenge(o[1], o[2])
    if tag == "+":
        return Sum(expr_from_obj(o[1]), expr_from_obj(o[2]))
    if tag == "*":
        return Product(expr_from_obj(o[1]), expr_from_obj(o[2]))
    if tag == "s":
        return Scaled(expr_from_obj(o[1]), int(o[2], 16))
    raise ValueError(f"bad expression tag {tag!r}")


def cs_to_obj(cs: ConstraintSystem) -> dict:
    return {
        "num_fixed": cs.num_fixed,
        "num_advice": cs.num_advice,
        "num_instance": cs.num_instance,
        "advice_phase": list(cs.advice_phase),
        "advice_unblinded": [bool(b) for b in cs.advice_unblinded],
        "num_challenges": cs.num_challenges,
        "gates": [[g.name, expr_to_obj(g.poly)] for g in cs.gates],
        "lookups": [
            [lk.name,
             [[expr_to_obj(e) for e in tup] for tup in lk.inputs],
             [expr_to_obj(e) for e in lk.table]]
            for lk in cs.lookups
        ],
        "shuffles": [
            [sh.name,
             [expr_to_obj(e) for e in sh.input],
             [expr_to_obj(e) for e in sh.table]]
            for sh in cs.shuffles
        ],
        "perm_columns": [[c.kind, c.index] for c in cs.perm_columns],
    }


def cs_from_obj(d: dict) -> ConstraintSystem:
    cs = ConstraintSystem(
        num_fixed=d["num_fixed"],
        num_advice=d["num_advice"],
        num_instance=d["num_instance"],
        advice_phase=list(d["advice_phase"]),
        advice_unblinded=[bool(b) for b in
                          d.get("advice_unblinded",
                                [False] * d["num_advice"])],
        num_challenges=d["num_challenges"],
    )
    cs.gates = [Gate(name, expr_from_obj(o)) for name, o in d["gates"]]
    cs.lookups = [
        Lookup(name,
               [tuple(expr_from_obj(e) for e in tup) for tup in inputs],
               tuple(expr_from_obj(e) for e in table))
        for name, inputs, table in d["lookups"]
    ]
    cs.shuffles = [
        Shuffle(name,
                tuple(expr_from_obj(e) for e in inp),
                tuple(expr_from_obj(e) for e in tab))
        for name, inp, tab in d.get("shuffles", [])
    ]
    cs.perm_columns = [Column(kind, idx) for kind, idx in d["perm_columns"]]
    return cs


# ---------------------------------------------------------------------------
# vk / pk files
# ---------------------------------------------------------------------------

def _pt_obj(p):
    return None if p is None else [hex(p[0]), hex(p[1])]


def _pt_from(o):
    return None if o is None else (int(o[0], 16), int(o[1], 16))


def vk_to_json(vk: VerifyingKey) -> str:
    return json.dumps({
        "format": FORMAT_VERSION,
        "kind": "ezkl_tpu.vk",
        "k": vk.k,
        "extended_k": vk.domain.extended_k,
        "cs": cs_to_obj(vk.cs),
        "fixed_commitments": [_pt_obj(p) for p in vk.fixed_commitments],
        "sigma_commitments": [_pt_obj(p) for p in vk.sigma_commitments],
    })


def vk_from_json(s: str) -> VerifyingKey:
    d = json.loads(s)
    if d.get("kind") != "ezkl_tpu.vk" or d.get("format") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported vk format {d.get('format')!r} (want {FORMAT_VERSION})")
    cs = cs_from_obj(d["cs"])
    dom = make_domain(d["k"], extended_k=d["extended_k"])
    return VerifyingKey(
        cs=cs, k=d["k"], domain=dom,
        fixed_commitments=[_pt_from(p) for p in d["fixed_commitments"]],
        sigma_commitments=[_pt_from(p) for p in d["sigma_commitments"]],
    )


def save_vk(vk: VerifyingKey, path):
    pathlib.Path(path).write_text(vk_to_json(vk))


def load_vk(path) -> VerifyingKey:
    return vk_from_json(pathlib.Path(path).read_text())


def save_pk(pk: ProvingKey, path):
    """The JAX package's npz members, stored uncompressed: at k = 20 they
    are 2.8 GB of 16-bit limbs, slow to deflate (np.load reads either
    form, so the file still loads in both packages)."""
    from ..convert import stack_to_ref
    with open(path, "wb") as f:
        np.savez(
            f,
            vk_json=np.frombuffer(vk_to_json(pk.vk).encode(), dtype=np.uint8),
            fixed_lagrange=stack_to_ref(pk.fixed_lagrange),
            sigma_lagrange=stack_to_ref(pk.sigma_lagrange),
            perm_maps=np.asarray(pk.perm_maps, dtype=np.int32),
        )


def load_pk(path, device=None) -> ProvingKey:
    """The Lagrange columns land on `device` (None: the card)."""
    from ..convert import stack_from_ref
    with np.load(pathlib.Path(path), allow_pickle=False) as z:
        vk = vk_from_json(bytes(z["vk_json"].tobytes()).decode())
        return ProvingKey(
            vk=vk,
            fixed_lagrange=stack_from_ref(z["fixed_lagrange"], device),
            sigma_lagrange=stack_from_ref(z["sigma_lagrange"], device),
            perm_maps=z["perm_maps"],
        )

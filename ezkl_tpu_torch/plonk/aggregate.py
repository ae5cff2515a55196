"""Batch proof aggregation: N KZG proofs -> ONE pairing check (port of
`ezkl_tpu/plonk/aggregate.py`; host-only, byte for byte its artifact).

Every accepted proof reduces (``verifier.verify_reduced``) to a pair of G1
points (L_i, R_i) with validity <=> e(L_i, [s]_2) == e(R_i, [1]_2). A
random linear combination r^i folds all N pairs into one equation

    e(sum_i r^i L_i, [s]_2) == e(sum_i r^i R_i, [1]_2)

sound by the Schwartz-Zippel argument as long as r is derived AFTER the
proofs are fixed (Fiat-Shamir over every vk repr + proof payload here).

The counterpart of ezkl's `aggregate` flow (`src/execute.rs` aggregate +
snark-verifier's KZG accumulation): the verifier-side cost collapse is the
same -- one pairing for N proofs -- but the combination runs natively
instead of inside a recursive halo2 circuit, so the artifact carries the N
inner proofs (verification stays O(N) scalar work).
"""

from __future__ import annotations

import json

from ..fieldmath import hostcurve as hc
from ..fieldmath.spec import bn254_fr
from . import pairing
from .prover import Proof
from .transcript import Transcript
from .verifier import verify_reduced

P = bn254_fr().modulus


def _challenge_r(vks, proofs: list[Proof]) -> int:
    """Fiat-Shamir RLC challenge binding every vk and proof byte."""
    tr = Transcript()
    tr.common_bytes(b"ezkl-tpu aggregate v1")
    tr.common_bytes(len(proofs).to_bytes(4, "big"))
    for vk, proof in zip(vks, proofs):
        tr.common_bytes(vk.transcript_repr())
        tr.common_bytes(proof.to_json().encode())
    return tr.challenge()


def aggregate(vks, proofs: list[Proof]) -> dict:
    """Combine N proofs into one aggregate artifact (JSON-able dict).

    Every inner proof is fully verified (reduced) first — aggregation of
    an invalid proof raises. vks: one per proof (the same object may
    repeat for same-circuit batches)."""
    if len(vks) != len(proofs) or not proofs:
        raise ValueError("need one vk per proof, at least one proof")
    reds = []
    for i, (vk, proof) in enumerate(zip(vks, proofs)):
        red = verify_reduced(vk, proof)
        if not red:
            raise ValueError(f"proof {i} failed verification; not aggregating")
        reds.append(red)
    r = _challenge_r(vks, proofs)
    lhs, rhs = None, None
    rpow = 1
    for (li, ri) in reds:
        lhs = hc.g1_add(lhs, hc.g1_mul(li, rpow))
        rhs = hc.g1_add(rhs, hc.g1_mul(ri, rpow))
        rpow = rpow * r % P
    return {
        "protocol": "ezkl-tpu-aggregate-v1",
        "num_proofs": len(proofs),
        "proofs": [json.loads(p.to_json()) for p in proofs],
        # combined pair, recorded for cheap pre-checks / EVM calldata;
        # verify_aggregated recomputes it from the inner proofs
        "lhs": [hex(lhs[0]), hex(lhs[1])] if lhs else None,
        "rhs": [hex(rhs[0]), hex(rhs[1])] if rhs else None,
    }


def verify_aggregated(vks, agg: dict, g2, s_g2) -> bool:
    """Check an aggregate artifact: re-reduce every inner proof (scalar
    work only — no per-proof pairings), re-derive r, and run the single
    folded pairing check."""
    if agg.get("protocol") != "ezkl-tpu-aggregate-v1":
        return False
    proofs = [Proof.from_json(json.dumps(pj)) for pj in agg["proofs"]]
    if len(vks) != len(proofs) or len(proofs) != agg.get("num_proofs"):
        return False
    reds = []
    for vk, proof in zip(vks, proofs):
        red = verify_reduced(vk, proof)
        if not red:
            return False
        reds.append(red)
    r = _challenge_r(vks, proofs)
    lhs, rhs = None, None
    rpow = 1
    for (li, ri) in reds:
        lhs = hc.g1_add(lhs, hc.g1_mul(li, rpow))
        rhs = hc.g1_add(rhs, hc.g1_mul(ri, rpow))
        rpow = rpow * r % P
    return pairing.pairing_check([
        (lhs, s_g2),
        (hc.g1_neg(rhs) if rhs else None, g2),
    ])

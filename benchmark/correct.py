"""The comparison that decides `correct`.

Once the window has closed, every proof the window finished is held to the
plain reference:

* `output_gap`: the largest gap, in units of the reference's output scale,
  between the model outputs that a proof carries in its instance column and
  the outputs of the plain fixed-point forward (`models/<model>.forward`)
  on that proof's input, at the configuration's scales. Exact: limit 0.
* `proofs_rejected`: of a sample of the proofs drawn from the seed
  (`verify_sample` of the traffic mix), how many the reference verifier
  (`reference/verifier.py`, with the SRS's secret) rejects. Limit 0.
* `srs_points_off`: of the SRS points [1]G, [tau]G and [tau^(n-1)]G, how
  many differ from what the seed's tau gives: the start of the proving path,
  checked by itself. Limit 0.
"""

from __future__ import annotations

import numpy as np

from . import harness
from .reference import bn254, verifier

LIMITS = {"output_gap": 0, "proofs_rejected": 0, "srs_points_off": 0}
COUNTS_DIFFER = float(1 << 62)


def signed(v: int) -> int:
    return v - bn254.R if v > bn254.R // 2 else v


def output_gap(outputs: list, want: np.ndarray, scale_out: int, scale_ref: int) -> float:
    """max |outputs * 2^(scale_ref - scale_out) - want|; COUNTS_DIFFER if the
    proof carries another number of outputs."""
    got = np.array([signed(v) for v in outputs], dtype=np.float64)
    if got.shape != want.shape:
        return COUNTS_DIFFER
    return float(np.max(np.abs(got * 2.0 ** (scale_ref - scale_out) - want), initial=0.0))


def compare(program, records: list, srs_points: list, config: dict, traffic: dict,
            seed: int) -> dict:
    tau = harness.srs_tau(seed)
    n = 1 << program.k
    want_srs = [bn254.G1, bn254.mul(bn254.G1, tau), bn254.mul(bn254.G1, pow(tau, n - 1, bn254.R))]
    srs_off = sum(a != b for a, b in zip(srs_points, want_srs)) + abs(len(srs_points) - 3)

    ra = config["run_args"]
    done = [r for r in records if r.get("text") is not None]
    gap = 0.0
    proofs = {}
    for i, r in enumerate(done):
        proof = verifier.parse_proof(r["text"])
        proofs[i] = proof
        want = program.model.forward(config, program.weights, r["x"],
                                     ra["input_scale"], ra["param_scale"]).astype(np.float64)
        inst = proof["instances"][0] if proof["instances"] else []
        gap = max(gap, output_gap(inst, want, program.output_scale(), ra["input_scale"]))

    circuit = verifier.circuit_of(program.vk)
    rng = harness.rng_for(seed, "verify sample")
    picked = sorted(rng.permutation(len(done))[:traffic["verify_sample"]].tolist())
    rejected = 0
    for i in picked:
        try:
            ok = verifier.verify(circuit, proofs[i], tau)
        except (KeyError, IndexError, ValueError, ZeroDivisionError):
            ok = False
        rejected += not ok
    values = {"output_gap": gap, "proofs_rejected": rejected, "srs_points_off": srs_off}
    return {name: {"value": values[name], "limit": LIMITS[name]} for name in LIMITS}

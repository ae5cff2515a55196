"""Freeze the JAX package's K=4 reference outputs for the port's tests.

Runs `ezkl_tpu` once on the two circuits of `tests/test_plonk.py` (the
mul + lookup + copy circuit and the shuffle circuit) and writes, under
`tests/fixtures/torch_port/`:

  srs_k4.json        gen_srs(4): k, the G1 powers as (16, n) Montgomery limbs
                     (x, y, z), and the two G2 points
  <circuit>.json     vk.transcript_repr(), the fixed and sigma commitments,
                     and create_proof(..., seed=1).to_json()

The port's tests (`tests/test_torch_prove.py`) compare against these files,
so the suite never compiles the JAX prover. Run from the repo root (it
compiles the JAX prover on the CPU: about half an hour on 8 cores):

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from ezkl_tpu.plonk import cs as csmod, keygen, prover, srs as srsmod  # noqa: E402
from ezkl_tpu.plonk.assign import Assignment  # noqa: E402
import torch_port_circuits as circuits  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "torch_port"
K = circuits.K
SEED = 1


def _pts(pts):
    return [None if p is None else [hex(p[0]), hex(p[1])] for p in pts]


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    srs = srsmod.gen_srs(K)
    (OUT / "srs_k4.json").write_text(json.dumps({
        "k": K,
        "g1": {c: np.asarray(getattr(srs.g1, c)).astype(np.uint32).tolist() for c in "xyz"},
        "g2": [[hex(v) for v in xy] for xy in srs.g2],
        "s_g2": [[hex(v) for v in xy] for xy in srs.s_g2],
    }))
    for name, (build, fill) in circuits.CIRCUITS.items():
        cs, cols = build(csmod)
        asg = fill(cs, cols, Assignment)
        pk = keygen.keygen(cs, K, srs, asg)
        proof = prover.create_proof(pk, srs, asg, seed=SEED)
        (OUT / f"{name}.json").write_text(json.dumps({
            "seed": SEED,
            "vk_repr": pk.vk.transcript_repr().hex(),
            "fixed_commitments": _pts(pk.vk.fixed_commitments),
            "sigma_commitments": _pts(pk.vk.sigma_commitments),
            "proof": proof.to_json(),
        }, indent=1))
        print(f"wrote {name}.json", flush=True)


if __name__ == "__main__":
    main()

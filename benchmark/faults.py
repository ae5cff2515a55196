"""Faults planted under the timed path, for the check that a broken
prover comes out not `correct` (`run.py --fault <kind>`, and the CPU
tests). Never used by a measured run.

    stale       each proof is the one before it: the prover's state left as it was
    eval        one evaluation of each proof altered where it is produced
    output      the first model output in each proof's instance altered
    commitment  two advice commitments of each proof swapped
    srs         the SRS made from another secret than the benchmark's
"""

from __future__ import annotations

import json
import pathlib

KINDS = ("stale", "eval", "output", "commitment", "srs")


def alter_json(d: dict, kind: str):
    """Plant `kind` in a proof's JSON object `d`."""
    if kind == "eval":
        label = sorted(d["evals"])[0]
        d["evals"][label] = hex(int(d["evals"][label], 16) ^ 1)
    elif kind == "output":
        d["instances"][0][0] = hex(int(d["instances"][0][0], 16) + 1)
    elif kind == "commitment":
        d["advice"][0], d["advice"][1] = d["advice"][1], d["advice"][0]


class Broken:
    """The graph entry with one fault planted in each proof it returns."""

    def __init__(self, entry, kind: str):
        self.entry, self.kind, self.last = entry, kind, None

    def prove(self, x):
        proof = self.entry.prove(x)
        if self.kind == "stale":
            out, self.last = self.last or proof, proof
            return out
        if isinstance(proof, pathlib.Path):          # the file entry's proof.json
            d = json.loads(proof.read_text())
            alter_json(d, self.kind)
            proof.write_text(json.dumps(d))
            return proof
        if self.kind == "eval":
            label = sorted(proof.evals)[0]
            proof.evals[label] ^= 1
        elif self.kind == "output":
            proof.instances[0][0] = proof.instances[0][0] + 1
        elif self.kind == "commitment":
            a = proof.advice_commitments
            a[0], a[1] = a[1], a[0]
        return proof

    def answer_text(self, answer):
        return self.entry.answer_text(answer)

    def close(self):
        self.entry.close()


def plant(kind: str):
    """The entry wrapper that plants `kind` (the SRS fault is planted in the
    program's `gen_srs` itself, for this process)."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}")
    if kind == "srs":
        from ezkl_tpu_torch.plonk import srs as srsmod
        gen = srsmod.gen_srs
        srsmod.gen_srs = lambda k, seed=b"", device=None: gen(k, seed + b"!", device=device)
        return None
    return lambda entry: Broken(entry, kind)

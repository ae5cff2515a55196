"""Means over the window's proofs of the program's `_span` phase seconds
(`plonk/prover.py` `PHASE_SECONDS`, read after each proof)."""


def mean_phase(r, name):
    vals = [p["phases"][name] for p in r.proofs if name in p["phases"]]
    return sum(vals) / len(vals) if vals else None

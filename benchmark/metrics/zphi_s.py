"""Per proof, seconds of the prover's phase 4: the permutation's grand
products and the lookups' grand sums on H (`plonk/prover.py`)."""

from ._phases import mean_phase

UNIT, SOURCE = "s", "program_span"
LAYER = "prover phases (plonk/prover.py, plonk/evaluator.py)"
MOVES = "prove_s"


def read(r):
    return mean_phase(r, "phase4: perm z + phi")

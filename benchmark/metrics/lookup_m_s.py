"""Per proof, seconds of the prover's phase 3: the lookups' multiplicities
counted and committed (`plonk/prover.py`)."""

from ._phases import mean_phase

UNIT, SOURCE = "s", "program_span"
LAYER = "prover phases (plonk/prover.py, plonk/evaluator.py)"
MOVES = "prove_s"


def read(r):
    return mean_phase(r, "phase3: lookups m")

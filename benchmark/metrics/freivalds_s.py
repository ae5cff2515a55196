"""Per proof, seconds of the prover's phase 2b: the Freivalds arguments'
second-phase witness (their RLC and dot running sums, on the host) computed
from the challenges and uploaded (`plonk/prover.py`). A program without the
span reads nothing."""

from ._phases import mean_phase

UNIT, SOURCE = "s", "program_span"
LAYER = "prover phases (plonk/prover.py, plonk/evaluator.py)"
MOVES = "prove_s"


def read(r):
    return mean_phase(r, "phase2b: freivalds witness")

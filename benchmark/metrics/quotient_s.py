"""Per proof, seconds of the prover's phase 5: the quotient over the
extended coset (`plonk/prover.py` stage_quotient, `plonk/evaluator.py`),
without its commitment (phase 5b)."""

from ._phases import mean_phase

UNIT, SOURCE = "s", "program_span"
LAYER = "prover phases (plonk/prover.py, plonk/evaluator.py)"
MOVES = "prove_s"


def read(r):
    return mean_phase(r, "phase5: quotient")

"""Share of the card's integer peak that the whole proof uses, in percent:
the Montgomery products an ideal prover of this circuit needs
(`work.prove_products`, from its shapes) at 264 IMAD each, over the traced
window's seconds per proof times 132 SMs x 64 IMAD x 1.98 GHz."""

from .. import work

UNIT, SOURCE = "%", "host_clock"
LAYER = "whole proof (plonk/prover.py create_proof)"
MOVES = "prove_s"


def read(r):
    if not r.trace or not r.proofs:
        return None
    return work.share(work.seconds_of(work.prove_products(r.shapes)),
                      r.window_s / len(r.proofs))

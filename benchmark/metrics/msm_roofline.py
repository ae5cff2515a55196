"""Share of its roofline that the commitments' point kernels reach, in
percent: the least time of the MSMs an ideal prover makes per proof
(Pippenger, `work.msm_products`, at the card's integer peak), over the
device seconds per proof of the program's point kernels (K3-K8) in the
trace."""

from .. import work
from ..trace import seconds_of_kernels

UNIT, SOURCE = "%", "device_trace"
LAYER = "commitments (plonk/kzg.py, kernels/msm.py, csrc/msm.cu)"
MOVES = "prove_s"
KERNELS = ("point_add_kernel", "point_reduce_kernel", "scan_packed_kernel",
           "scan_steps_kernel", "fold_lanes_kernel", "dbl_pow2_kernel", "horner_kernel")


def read(r):
    if not r.trace or not r.proofs:
        return None
    measured = seconds_of_kernels(r.trace, KERNELS) / len(r.proofs)
    return work.share(work.msm_seconds(r.shapes), measured)

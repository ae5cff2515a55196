"""Share of its roofline that the transforms' kernel reaches, in percent:
the least time of the transforms an ideal prover needs per proof
(`work.transforms`, by products or bytes), over the device seconds per
proof of the program's NTT stage kernel (K2) in the trace."""

from .. import work
from ..trace import seconds_of_kernels

UNIT, SOURCE = "%", "device_trace"
LAYER = "transforms (kernels/ntt.py, csrc/field.cu)"
MOVES = "prove_s"
KERNELS = ("ntt_stages_kernel",)


def read(r):
    if not r.trace or not r.proofs:
        return None
    measured = seconds_of_kernels(r.trace, KERNELS) / len(r.proofs)
    return work.share(work.transform_seconds(r.shapes), measured)

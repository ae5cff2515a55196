"""End to end: seconds from the process's start to the end of the
warm-up proof: imports and the kernel library, the model, settings and
compiled circuit, the SRS on the card, keygen and one proof."""

UNIT, SOURCE = "s", "host_clock"


def read(r):
    return r.setup_s

"""End to end: the window's seconds per proof. The window runs from the
first proof's start to the last proof's end, so this is the mean time of
a proof to the one client, all of them counted."""

UNIT, SOURCE = "s", "host_clock"


def read(r):
    return r.window_s / len(r.proofs) if r.proofs else None

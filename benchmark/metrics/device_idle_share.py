"""Share of the traced window in which no operation ran on the card, in
percent: 1 - busy / window, from `torch.profiler`'s device events."""

UNIT, SOURCE = "%", "device_trace"
LAYER = "device (NVIDIA H100)"
MOVES = "prove_s"


def read(r):
    t = r.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

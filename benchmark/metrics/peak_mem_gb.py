"""End to end: the card's peak allocated memory over the window, in GB
(1e9 bytes), from `torch.cuda.max_memory_allocated` reset as the window
opens. It decides which k one card proves."""

UNIT, SOURCE = "GB", "host_clock"


def read(r):
    return r.peak_window_bytes / 1e9 if r.peak_window_bytes else None

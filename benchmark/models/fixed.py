"""Fixed-point arithmetic of the plain references, in numpy int64."""

from __future__ import annotations

import numpy as np


def quantize(a, scale: int) -> np.ndarray:
    """round(a * 2^scale), ties to even."""
    return np.rint(np.asarray(a, np.float64) * float(1 << scale)).astype(np.int64)


def rounded_div(x: np.ndarray, d: int) -> np.ndarray:
    """round(x / d) for int64 x and a positive integer d, ties to even,
    exact for |x| < 2^53."""
    x = np.asarray(x, np.int64)
    if np.abs(x).max(initial=0) >= 1 << 53:
        raise OverflowError("fixed-point value beyond 2^53")
    return np.rint(x / d).astype(np.int64)

"""Fixed-point quantization over int64 (reference: IntegerRep = i128,
`ezkl/src/fieldutils.rs:6`; quantize_float round-half-even,
`ezkl/src/graph/utilities.rs:53-69`).

All witness math runs vectorized in numpy int64; magnitudes are guarded so
int64 never silently wraps (the reference relies on i128 headroom instead).

Port of `ezkl_tpu/graph/quantize.py` (pure numpy, copied; imports rewired to the
port's modules).
"""

from __future__ import annotations

import numpy as np

I64_MAX = np.iinfo(np.int64).max


def quantize(arr, scale: int) -> np.ndarray:
    """float array -> int64 fixed point at 2^scale (round half to even —
    numpy's np.rint semantics match the reference's f64::round_ties_even)."""
    a = np.asarray(arr, dtype=np.float64)
    mult = float(1 << scale) if scale >= 0 else 1.0 / (1 << -scale)
    return np.rint(a * mult).astype(np.int64)


def dequantize(arr, scale: int) -> np.ndarray:
    a = np.asarray(arr, dtype=np.float64)
    mult = float(1 << scale) if scale >= 0 else 1.0 / (1 << -scale)
    return a / mult


def scale_to_multiplier(scale: int) -> float:
    return float(1 << scale) if scale >= 0 else 1.0 / (1 << -scale)


def check_range(arr: np.ndarray, bits: int = 60):
    """Guard against int64 overflow in accumulation-heavy ops."""
    if arr.size and int(np.abs(arr).max()) >= (1 << bits):
        raise OverflowError(
            f"quantized magnitude {int(np.abs(arr).max())} exceeds 2^{bits}; "
            "lower the scales")
    return arr


def checked_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """int64 product with PRE-multiplication overflow guard.

    Checking after the fact is unsound: two in-range operands can produce a
    product that wraps mod 2^64 back into the accepted range. Bound the
    operand magnitudes first (|a|max * |b|max < 2^62)."""
    if a.size and b.size:
        ma = int(np.abs(a).max())
        mb = int(np.abs(b).max())
        if ma and mb and ma * mb >= (1 << 62):
            raise OverflowError(
                f"product magnitude ~{ma}*{mb} would exceed 2^62; lower the "
                "scales")
    return a * b


def checked_cumsum(x: np.ndarray, axis: int) -> np.ndarray:
    """Cumulative sum with an overflow guard on intermediates (abs-sum bound
    estimated in float64)."""
    est = np.cumsum(np.abs(x).astype(np.float64), axis=axis)
    if est.size and float(est.max()) >= float(1 << 62):
        raise OverflowError(
            "cumulative sum would exceed 2^62; lower the scales")
    return np.cumsum(x, axis=axis)


def checked_cumprod(x: np.ndarray, axis: int) -> np.ndarray:
    """Cumulative product with an overflow guard on the INTERMEDIATE values
    (estimated in float64 — an int64 cumprod can wrap mid-run and land back
    in range)."""
    est = np.cumprod(np.abs(x).astype(np.float64), axis=axis)
    if est.size and float(est.max()) >= float(1 << 62):
        raise OverflowError(
            "cumulative product would exceed 2^62; lower the scales")
    return np.cumprod(x, axis=axis)

"""K2: the radix-2 NTT butterfly stage.

Replaces the TPU kernel `_bfly_call` of `ezkl_tpu/kernels/pntt.py` (entry
`bfly`), which took three materialised (16, n) arrays a, b, w. Here one call
is one whole stage: `x` holds consecutive blocks of 2*half elements along its
last axis and `w` is the stage's twiddle table of `half` entries; within each
block, with a = first half and b = second half, the stage writes
(a + b*w[j], a - b*w[j]). The CUDA kernel (`csrc/field.cu`) computes j mod
half itself, so no broadcast twiddle array and no concat is ever built.
"""

from __future__ import annotations

import torch

from ..fieldmath import limbs
from ..fieldmath.spec import FieldSpec, NWORDS
from . import build


@torch.inference_mode()
def bfly_plain(spec: FieldSpec, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 (either device)."""
    half = w.shape[-1]
    xr = x.reshape(NWORDS, -1, 2, half)
    a, b = limbs._w(xr[:, :, 0]), limbs._w(xr[:, :, 1])
    t = limbs.mont_mul_w(spec, b, limbs._w(w)[:, None, :].expand(b.shape).contiguous())
    hi, lo = limbs.add_w(spec, a, t), limbs.sub_w(spec, a, t)
    return limbs._i32(torch.stack([hi, lo], dim=2)).reshape(x.shape)


def _bfly_kernel(spec: FieldSpec, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    lib = build.lib()
    half = w.shape[-1]
    x2 = x.reshape(NWORDS, -1).contiguous()
    w2 = w.contiguous()
    build.require_card("bfly", x2)
    build.require_card("bfly", w2)
    if w2.device != x2.device:
        raise ValueError("bfly: x and w must be on one device")
    n = x2.shape[1]
    out = torch.empty_like(x2)
    if n:
        build.check(lib.ez_bfly(limbs._FIELD_ID[spec.name], x2.data_ptr(), w2.data_ptr(),
                                out.data_ptr(), n, half.bit_length() - 1,
                                build.stream_of(x2)), "bfly")
        build.LAUNCHES["bfly"] += 1
        build.WIDTHS.append(("bfly", spec.name, n, n // 2))
    return out.reshape(x.shape)


def bfly(spec: FieldSpec, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One butterfly stage over (8, *batch, n), n a multiple of 2*half, with
    the stage twiddles w: (8, half), half a power of two (K2)."""
    half = w.shape[-1]
    assert half & (half - 1) == 0 and x.shape[-1] % (2 * half) == 0
    if x.is_cuda:
        return _bfly_kernel(spec, x, w)
    return bfly_plain(spec, x, w)

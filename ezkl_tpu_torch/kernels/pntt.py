"""K2: radix-2 NTT butterfly stages.

Replaces the TPU kernel `_bfly_call` of `ezkl_tpu/kernels/pntt.py` (entry
`bfly`), which took three materialised (16, n) arrays a, b, w and ran one
stage. Here one launch runs a pass: r consecutive stages s0+1 .. s0+r of the
bit-reversed-input DIT transform over every column of an (8, *batch, 2^k)
array, the elements those stages connect held in shared memory
(`csrc/field.cu` `ez_ntt_stages`). Stage s pairs the elements 2^(s-1) apart
in blocks of 2^s and writes (a + b*w, a - b*w) with w = w_{2^s}^j, j the
position in the block, read from the transform's one master table
[w^0 .. w^(2^(k-1) - 1)] at j * 2^(k-s). A transform of 2^k points is
`pass_split(k)`: ceil(k / 10) passes of nearly equal length.

`bfly`, one stage with its own twiddle table of `half` entries, is the same
kernel with r = 1: that table is the master table of a transform of 2 * half
points, the blocks of 2 * half elements its columns.
"""

from __future__ import annotations

import torch

from ..fieldmath import limbs
from ..fieldmath.spec import FieldSpec, NWORDS
from . import build

MAX_STAGES = 10          # 2^10 elements of 32 B: the kernel's 32 KB tile
TILE = 1 << MAX_STAGES
# groups per block: up to 4, as long as 64 blocks remain. From the H100
# sweep of every groups-per-block choice at the prove's 1 x 2^14, 8 x 2^14
# and 16 x 2^17 (`chip_smoke.py`): within 5% of the fastest choice at each
# of their passes (PERF.md, K2's row).
MAX_GROUPS = 4
MIN_BLOCKS = 64


def pass_split(k: int) -> list:
    """Stages 1 .. k as (s0, r) passes: ceil(k / 10) runs of r <= 10 stages,
    nearly equal, the longer first (k = 14: 7 + 7; k = 17: 9 + 8)."""
    passes = -(-k // MAX_STAGES)
    out, s0 = [], 0
    for i in range(passes):
        r = k // passes + (i < k % passes)
        out.append((s0, r))
        s0 += r
    return out


def max_log_groups(k: int, s0: int, r: int) -> int:
    """log2 of the most groups of 2^r elements `ez_ntt_stages` takes in a
    block: within the tile, a column and, past the first pass, the 2^s0
    adjacent groups of one stride run."""
    return min(MAX_STAGES - r, k - r, s0 if s0 else MAX_STAGES)


def groups_per_block(cols: int, k: int, s0: int, r: int) -> int:
    """log2 of the groups a block of `ez_ntt_stages` takes: up to MAX_GROUPS
    while MIN_BLOCKS blocks remain."""
    groups = cols << (k - r)
    cap = min(MAX_GROUPS, 1 << max_log_groups(k, s0, r))
    gb = 1
    while gb * 2 <= cap and groups // (gb * 2) >= MIN_BLOCKS:
        gb *= 2
    return gb.bit_length() - 1


def stage_twiddles(master: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Stage s's table w_{2^s}^j, j < 2^(s-1), from the master table of a
    2^k-point transform."""
    return master[:, :: 1 << (k - s)][:, : 1 << (s - 1)]


@torch.inference_mode()
def bfly_plain(spec: FieldSpec, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one stage (either device)."""
    half = w.shape[-1]
    xr = x.reshape(NWORDS, -1, 2, half)
    a, b = limbs._w(xr[:, :, 0]), limbs._w(xr[:, :, 1])
    t = limbs.mont_mul_w(spec, b, limbs._w(w)[:, None, :].expand(b.shape).contiguous())
    hi, lo = limbs.add_w(spec, a, t), limbs.sub_w(spec, a, t)
    return limbs._i32(torch.stack([hi, lo], dim=2)).reshape(x.shape)


def stages_plain(spec: FieldSpec, x: torch.Tensor, master: torch.Tensor, k: int, s0: int,
                 r: int) -> torch.Tensor:
    """Plain PyTorch version of K2: stages s0+1 .. s0+r, each a `bfly_plain`
    with its twiddles from the master table."""
    for s in range(s0 + 1, s0 + r + 1):
        x = bfly_plain(spec, x, stage_twiddles(master, k, s))
    return x


def _stages_kernel(spec: FieldSpec, x: torch.Tensor, master: torch.Tensor, k: int, s0: int,
                   r: int, log_gb: int | None = None) -> torch.Tensor:
    lib = build.lib()
    n = 1 << k
    x2 = x.reshape(NWORDS, -1).contiguous()
    tw = master.contiguous()
    build.require_card("ntt_stages", x2)
    build.require_card("ntt_stages", tw)
    if tw.device != x2.device:
        raise ValueError("ntt_stages: x and the twiddles must be on one device")
    if tw.shape[1] != n // 2 or x2.shape[1] % n:
        raise ValueError("ntt_stages: want columns of 2^k and a master table of 2^(k-1)")
    cols = x2.shape[1] // n
    out = torch.empty_like(x2)
    if cols:
        if log_gb is None:
            log_gb = groups_per_block(cols, k, s0, r)
        build.check(lib.ez_ntt_stages(limbs._FIELD_ID[spec.name], x2.data_ptr(), tw.data_ptr(),
                                      out.data_ptr(), cols, k, s0, r, log_gb,
                                      build.stream_of(x2)), "ntt_stages")
        build.LAUNCHES["ntt_stages"] += 1
        build.WIDTHS.append(("ntt_stages", spec.name, cols * n, r * cols * n // 2))
    return out.reshape(x.shape)


def stages(spec: FieldSpec, x: torch.Tensor, master: torch.Tensor, k: int, s0: int,
           r: int) -> torch.Tensor:
    """Stages s0+1 .. s0+r (r <= 10) of the DIT transform along the last
    axis of (8, *batch, 2^k), master: (8, 2^(k-1)) twiddles (K2)."""
    assert 1 <= r <= MAX_STAGES and s0 + r <= k and x.shape[-1] == 1 << k
    if x.is_cuda:
        return _stages_kernel(spec, x, master, k, s0, r)
    return stages_plain(spec, x, master, k, s0, r)


def bfly(spec: FieldSpec, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One butterfly stage over (8, *batch, n), n a multiple of 2*half, with
    the stage twiddles w: (8, half), half a power of two (K2, r = 1)."""
    half = w.shape[-1]
    assert half & (half - 1) == 0 and x.shape[-1] % (2 * half) == 0
    if x.is_cuda:
        k = half.bit_length()
        cols = x.reshape(NWORDS, -1).shape[1] >> k
        return _stages_kernel(spec, x.reshape(NWORDS, cols, 1 << k), w, k, k - 1,
                              1).reshape(x.shape)
    return bfly_plain(spec, x, w)

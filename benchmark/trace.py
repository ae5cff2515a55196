"""Reduce a `torch.profiler` trace of the window to the device's busy time,
the device time per operation name, and the idle time per prover phase.

The raw events are read directly (building PyTorch's per-event objects for
a whole prove takes minutes), as the repository's prove profiler does. The
phases are the program's `torch.profiler` ranges, one per `_span` phase of
`create_proof`; the window is the benchmark's own range around it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW_RANGE = "benchmark window"
OUTSIDE = "outside create_proof"
TOP = 10


def _union(intervals):
    """Merged (start, end) of sorted intervals."""
    out = []
    for lo, hi in intervals:
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def reduce_profile(prof, device) -> dict:
    """`reduce_events` of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType
    dev_type = DeviceType.CUDA if device.type == "cuda" else None
    ops, ranges, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == dev_type:
            if not e.is_user_annotation():
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name == WINDOW_RANGE or name.startswith("phase"):
            lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
            if name == WINDOW_RANGE:
                window = (lo, hi)
            else:
                ranges.append((lo, hi, name))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    return reduce_events(ops, ranges, window)


def reduce_events(ops, ranges, window) -> dict:
    """From the device operations `ops` (start ns, end ns, name), the
    program's phase ranges `ranges` (start ns, end ns, name) and the traced
    window (start ns, end ns): the device's busy seconds (the union of its
    operations), the window's seconds, the device seconds per operation
    name, the top operations, and the idle seconds inside the window per
    phase (what the host was doing while the card waited)."""
    ops = sorted(ops)
    busy = _union([(lo, hi) for lo, hi, _ in ops])
    by_name = defaultdict(int)
    for lo, hi, name in ops:
        by_name[name] += hi - lo
    idle, t = [], window[0]
    for lo, hi in busy:
        if lo > t:
            idle.append((t, min(lo, window[1])))
        t = max(t, hi)
    if t < window[1]:
        idle.append((t, window[1]))
    ranges = sorted(ranges)
    starts = [lo for lo, _, _ in ranges]
    per_phase = defaultdict(int)
    for lo, hi in idle:
        covered = 0
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(ranges) and ranges[i][0] < hi:
            r_lo, r_hi, name = ranges[i]
            part = min(hi, r_hi) - max(lo, r_lo)
            if part > 0:
                per_phase[name] += part
                covered += part
            i += 1
        if hi - lo > covered:
            per_phase[OUTSIDE] += (hi - lo) - covered
    busy_ns = sum(min(hi, window[1]) - max(lo, window[0]) for lo, hi in busy
                  if hi > window[0] and lo < window[1])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (window[1] - window[0]) / 1e9,
        "ops_s": {name: ns / 1e9 for name, ns in ranked},
        "device_ops": [[name[:120], ns / 1e9] for name, ns in ranked[:TOP]],
        "idle_gaps": [[name, ns / 1e9] for name, ns in
                      sorted(per_phase.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def seconds_of_kernels(trace: dict, patterns) -> float:
    """Device seconds of every operation whose name holds one of `patterns`."""
    return sum(s for name, s in trace["ops_s"].items() if any(p in name for p in patterns))

#!/usr/bin/env python3
"""Profile one `create_proof` of the PyTorch/CUDA port on the card.

    python3 tools/profile_torch_prove.py [--k 14] [--graph [mlp_4d|conv2d_mnist]]

Builds the kernels, keys the circuit of `chip_smoke.py` (k = 14 unless
told; with `--graph` instead the graded mlp_4d model of its graph phase,
keyed through the file API in a temporary directory at the k its settings
settle on; with `--graph conv2d_mnist` the graded conv2d_mnist of its
conv2d_mnist phase at k = 20), proves once to warm up, once more timed, and
once under
`torch.profiler`, then runs `gen_srs` once more under it. Prints the card's
name and power limit as nvidia-smi gives them, a `profile_gen_srs` line
(its profiled wall and device busy seconds, launches, `top` and `widths` as
below: K9's 2^k-lane doublings among them), then one JSON line:

  wall_s          host time of the timed create_proof (ends synchronized)
  peak_bytes      the card's peak allocated bytes in the timed create_proof,
                  and per phase (`prover.PHASE_PEAK_BYTES`)
  profiled_wall_s the same for the profiled run (the profiler's own cost in)
  device_busy_s   sum of the durations of the device's kernels, copies and
                  sets in the profiled run (one stream: they do not overlap)
  busy_share      device_busy_s / profiled_wall_s; the device idles the rest
  busy_share_of_wall  device_busy_s / wall_s: the same device time against
                  the unprofiled prove (the profiler slows the host, not the
                  device, so this is the share a plain prove sees)
  phases          per prover phase (`prover._span` ranges): wall_s, busy_s,
                  device_ops
  top             device operations by total time: name, count, total_ms;
                  the first 15, and past them every one whose name matches
                  `--match` (e.g. `fold_lanes|dbl_pow2` for K6 and K7)
  launches        kernel launches of the timed create_proof (`build.LAUNCHES`)
  point_launches  the point kernels' share of them (K3-K9)
  widths          K1 (its three forms: mont_mul, mont_pow, mont_scan), K2
                  (ntt_stages), K3 (point_add, and its tree form
                  point_reduce) and K4-K8 (scan_packed, scan_steps,
                  fold_lanes, dbl_pow2, horner) launches of the profiled
                  create_proof per kernel, field and power-of-two width
                  (`build.WIDTHS`; elements, for mont_scan rows x steps,
                  for K3 lanes in, for K4-K8 lanes: C x 3,328 for K4,
                  C x 104 and C x 26 for K5, C x 3,328 for K6, C x 26 for
                  K7 and C for K8 at k = 14 with C committed columns),
                  each with the device ms of those
                  launches (the i-th launch of a kernel is the i-th device
                  event of its name), their summed bound and the gap
                  between the two (`<kernel>_unpaired` says so where the
                  counts or fields do not pair)

Needs one CUDA card and exits non-zero without one, or when the profiler
records no device activity.
"""

from __future__ import annotations

import argparse
import bisect
import json
import pathlib
import re
import sys
import tempfile
import time
from collections import defaultdict

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

TOP = 15


# bytes per element of a K1-K3 or K9 launch: K1 reads two operands and
# writes one (a broadcast operand counted in full, so its bound is a
# ceiling); its chain forms and a K2 pass read and write each element once
# (K2's twiddles, at most half as many, left out, so its bound is a floor);
# K3 reads two points and writes one per lane, its tree reads one point per
# partial (its one output per group left out); K9 reads a point and writes
# one. K4-K8 record their bytes.
BYTES_PER_ELEMENT = {"mont_mul": 96, "mont_pow": 64, "mont_scan": 64, "ntt_stages": 64,
                     "point_add": 288, "point_reduce": 96, "point_dbl": 192}
# kernels compiled once per field, whose device names end in `<Fr>`/`<Fq>`
PER_FIELD = ("mont_mul", "mont_pow", "mont_scan", "ntt_stages")


def _bound_ms(kernel, n, products, nbytes=None):
    """`chip_smoke.bound` of one launch over n elements with `products`
    Montgomery products and `nbytes` moved (K1-K3: from BYTES_PER_ELEMENT)."""
    if nbytes is None:
        nbytes = BYTES_PER_ELEMENT[kernel] * n
    return chip_smoke.bound(nbytes, chip_smoke.IMAD_PER_MONT_MUL * products)[0]


def _widths(ops, widths):
    """{kernel/field: {2^k: {"launches", "device_ms", "bound_ms", "gap_ms"}}}
    from the launch record `widths` and the device operations `ops` (start,
    ns, name); gap = device time - bound, summed over the launches."""
    from ezkl_tpu_torch.kernels import build
    hist = build.width_histogram(widths)
    out = {key: {w: {"launches": c, "device_ms": 0.0, "bound_ms": 0.0} for w, c in row.items()}
           for key, row in hist.items()}
    for kernel in sorted({w[0] for w in widths}):
        mine = [w[1:] for w in widths if w[0] == kernel]
        events = sorted((s, d, name) for s, d, name in ops if f"{kernel}_kernel" in name)
        if len(mine) != len(events) or kernel in PER_FIELD and any(
                f"{'Fr' if w[0].endswith('fr') else 'Fq'}>" not in name
                for w, (_, _, name) in zip(mine, events)):
            out[f"{kernel}_unpaired"] = f"{len(mine)} launches, {len(events)} device events"
            continue
        for (field, n, prods, *nbytes), (_, ns, _) in zip(mine, events):
            cell = out[f"{kernel}/{field}"][f"2^{(n - 1).bit_length()}"]
            cell["device_ms"] += ns / 1e6
            cell["bound_ms"] += _bound_ms(kernel, n, prods, *nbytes)
    for row in out.values():
        for cell in row.values() if isinstance(row, dict) else ():
            cell["gap_ms"] = cell["device_ms"] - cell["bound_ms"]
    return out


def _breakdown(events, device_type, phase_names):
    """Device time in total, per phase and per operation name, from the raw
    profiler events (read directly: building PyTorch's per-event objects for
    a whole prove takes minutes)."""
    ops, spans = [], {}
    for e in events:
        name = e.name()
        if name in phase_names:
            if e.device_type() != device_type:          # the host-side range
                spans[name] = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif e.device_type() == device_type and not e.is_user_annotation():
            ops.append((e.start_ns(), e.duration_ns(), name))
    if not ops:
        raise RuntimeError("the profiler recorded no device activity")
    ops.sort()
    starts = [s for s, _, _ in ops]
    phases = {}
    for name, (lo, hi) in sorted(spans.items(), key=lambda kv: kv[1]):
        inside = ops[bisect.bisect_left(starts, lo):bisect.bisect_left(starts, hi)]
        phases[name] = {"wall_s": (hi - lo) / 1e9,
                        "busy_s": sum(d for _, d, _ in inside) / 1e9,
                        "device_ops": len(inside)}
    busy = sum(d for _, d, _ in ops) / 1e9
    return busy, phases, ops


def _top(ops, match=None):
    """Device operations `ops` (start, ns, name) by name, in order of total
    time: the first TOP, then every later one whose name matches `match`."""
    by_name = defaultdict(lambda: [0, 0])
    for _, d, name in ops:
        by_name[name][0] += 1
        by_name[name][1] += d
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    keep = ranked[:TOP] + [kv for kv in ranked[TOP:] if match and re.search(match, kv[0])]
    return [{"name": name[:120], "count": c, "total_ms": ns / 1e6} for name, (c, ns) in keep]


def _graph_key(dev, wd, model):
    """`model` (mlp_4d, or conv2d_mnist at k = 20) keyed through the port's
    file API in `wd`: (pk, srs, its finalized assignment, k), the key and
    SRS loaded from their files."""
    from ezkl_tpu_torch import api
    from ezkl_tpu_torch.graph import onnx_writer
    from ezkl_tpu_torch.graph.circuit import GraphSettings
    from ezkl_tpu_torch.graph.run_args import RunArgs
    from ezkl_tpu_torch.plonk import serde, srs as srsmod

    onnx, inp = getattr(chip_smoke, model)(onnx_writer)
    f = {name: str(wd / name) for name in ("network.onnx", "input.json", "settings.json",
                                           "model.compiled", "kzg.srs", "vk.key", "pk.key")}
    pathlib.Path(f["network.onnx"]).write_bytes(onnx)
    pathlib.Path(f["input.json"]).write_text(json.dumps(inp))
    if model == chip_smoke.CONV_MODEL:
        api.gen_settings(f["network.onnx"], f["settings.json"])
        st = chip_smoke.with_logrows(f["settings.json"], chip_smoke.K20, GraphSettings)
    else:
        st = api.gen_settings(f["network.onnx"], f["settings.json"],
                              RunArgs(logrows=chip_smoke.GRAPH_LOGROWS))
    k = st.run_args.logrows
    api.compile_circuit(f["network.onnx"], f["settings.json"], f["model.compiled"])
    api.gen_srs(f["kzg.srs"], k, device=dev)
    api.setup(f["model.compiled"], f["input.json"], f["kzg.srs"], f["vk.key"], f["pk.key"],
              device=dev)
    gc = api.load_compiled(f["model.compiled"])
    arrays = api._reshape_for(gc, api._load_input(f["input.json"], gc.model.input_scales()))
    _, ctx, _ = gc.forward(arrays)
    return (serde.load_pk(f["pk.key"], dev), srsmod.load(f["kzg.srs"], dev),
            ctx.finalize(), k)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=chip_smoke.K)
    ap.add_argument("--match", help="also list in `top` every device operation past "
                    "the first 15 whose name matches this regular expression")
    ap.add_argument("--graph", nargs="?", const=chip_smoke.GRAPH_MODEL,
                    choices=[chip_smoke.GRAPH_MODEL, chip_smoke.CONV_MODEL],
                    help="profile a graded model of chip_smoke.py (alone: mlp_4d)")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    if not torch.cuda.is_available():
        print("profile_torch_prove: no CUDA device", file=sys.stderr)
        return 2
    from ezkl_tpu_torch.kernels import build
    from ezkl_tpu_torch.plonk import keygen, prover, srs as srsmod

    print(chip_smoke.nvidia_smi(), flush=True)
    build.lib()
    dev = torch.device("cuda", 0)
    if args.graph:
        with tempfile.TemporaryDirectory() as wd:
            pk, srs, asg, args.k = _graph_key(dev, pathlib.Path(wd), args.graph)
    else:
        cs, asg, _ = chip_smoke.build_circuit(np.random.default_rng(chip_smoke.SEED), args.k)
        srs = srsmod.gen_srs(args.k, device=dev)
        pk = keygen.keygen(cs, args.k, srs, asg, device=dev)

    def prove():
        t0 = time.perf_counter()
        prover.create_proof(pk, srs, asg, seed=chip_smoke.SEED)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prove()                                        # warm-up
    build.reset_launches()
    wall = prove()
    launches = dict(build.LAUNCHES)
    phase_peak = dict(prover.PHASE_PEAK_BYTES)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    build.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        profiled_wall = prove()
    widths = list(build.WIDTHS)
    busy, phases, ops = _breakdown(prof.profiler.kineto_results.events(), DeviceType.CUDA,
                                   set(prover.PHASE_SECONDS))
    build.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        srsmod.gen_srs(args.k, device=dev)
        torch.cuda.synchronize()
        srs_wall = time.perf_counter() - t0
    srs_busy, _, srs_ops = _breakdown(prof.profiler.kineto_results.events(), DeviceType.CUDA,
                                      set())
    chip_smoke.emit({"phase": "profile_gen_srs", "k": args.k, "profiled_wall_s": srs_wall,
                     "device_busy_s": srs_busy, "launches": dict(build.LAUNCHES),
                     "top": _top(srs_ops, args.match),
                     "widths": _widths(srs_ops, list(build.WIDTHS))})
    chip_smoke.emit({"phase": "profile", "k": args.k,
                     "circuit": args.graph or "stand-in",
                     "wall_s": wall, "peak_bytes": max(phase_peak.values()),
                     "phase_peak_bytes": phase_peak,
                     "profiled_wall_s": profiled_wall, "device_busy_s": busy,
                     "busy_share": busy / profiled_wall, "busy_share_of_wall": busy / wall,
                     "phases": phases, "top": _top(ops, args.match), "launches": launches,
                     "point_launches": sum(launches[k] for k in chip_smoke.POINT_KERNELS),
                     "widths": _widths(ops, widths),
                     "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())

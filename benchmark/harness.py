"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, traffic mix, entry or metric
sits in a file of its own that is found by name:

    BENCHMARK.json               the cells and the metrics
    benchmark/configs/<c>.json   a configuration (its `model` names
                                 benchmark/models/<model>.py, which builds
                                 the ONNX model and holds its plain reference)
    benchmark/traffic/<t>.json   a traffic mix (its `entry` names
                                 benchmark/entries/<entry>.py)
    benchmark/metrics/<m>.py     a metric's reader

A run sets the program up (`setup_s`), drives the entry for `--seconds` in
a closed loop of one client with a fresh input per proof, judges every
answer against the plain reference once the window has closed, and prints
the result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
# modules that may not be loaded in a run (compared by top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "ezkl_tpu")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(spec: dict, workload: str) -> Cell:
    """The cell `workload` of `spec` with its configuration, traffic and
    metrics read from their files."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    traffic = json.loads((BENCH / "traffic" / f"{wl['traffic']}.json").read_text())
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError(f"traffic {wl['traffic']!r}: the harness drives one closed-loop client")
    return Cell(
        name=workload, chips=wl["chips"],
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)])


def metric_reader(name: str):
    return importlib.import_module(f"benchmark.metrics.{name}")


def model_of(config: dict):
    return importlib.import_module(f"benchmark.models.{config['model']}")


def entry_of(traffic: dict):
    return importlib.import_module(f"benchmark.entries.{traffic['entry']}")


# ---------------------------------------------------------------------------
# inputs and weights from the seed
# ---------------------------------------------------------------------------

def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of `seed` (any whole number)."""
    words = [seed % (1 << 64), *stream.encode()]
    return np.random.default_rng(np.random.SeedSequence(words))


def draw_input(config: dict, rng: np.random.Generator) -> np.ndarray:
    spec = config["input"]
    shape = tuple(config["input_shape"])
    if spec["kind"] == "integers":
        return rng.integers(spec["low"], spec["high"], shape).astype(np.float64)
    if spec["kind"] == "uniform":
        return rng.uniform(spec["low"], spec["high"], shape)
    raise ValueError(f"unknown input kind {spec['kind']!r}")


def srs_seed(seed: int) -> bytes:
    return f"benchmark srs {seed}".encode()


def srs_tau(seed: int) -> int:
    """The secret of the SRS the benchmark asks the program for: the
    scalar that `gen_srs` derives from its seed (blake2b-256, little
    endian, mod r)."""
    import hashlib
    from .reference.bn254 import R
    return int.from_bytes(hashlib.blake2b(srs_seed(seed), digest_size=32).digest(),
                          "little") % R


def run_args_of(config: dict, control: str | None) -> dict:
    ra = dict(config["run_args"])
    if control:
        ra.update(config["controls"][control])
    return ra


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

class Program:
    """The configuration keyed by the program, in a work directory: the
    ONNX model, settings and compiled circuit, the SRS made on the device
    from the seed, and the proving key made in this process."""

    def __init__(self, config: dict, seed: int, workdir: pathlib.Path, device,
                 control: str | None = None):
        from ezkl_tpu_torch import api
        from ezkl_tpu_torch.graph.run_args import RunArgs
        from ezkl_tpu_torch.plonk import srs as srsmod

        self.config, self.workdir, self.device = config, workdir, device
        self.model = model_of(config)
        self.weights = self.model.draw_weights(config, rng_for(seed, "weights"))
        self.files = {name: str(workdir / name) for name in
                      ("network.onnx", "settings.json", "model.compiled", "kzg.srs", "pk.key")}
        pathlib.Path(self.files["network.onnx"]).write_bytes(
            self.model.build(config, self.weights))
        ra = run_args_of(config, control)
        ra["lookup_range"] = tuple(ra["lookup_range"])
        st = api.gen_settings(self.files["network.onnx"], self.files["settings.json"],
                              RunArgs(**ra))
        if config.get("logrows"):
            st.run_args.logrows = config["logrows"]
            pathlib.Path(self.files["settings.json"]).write_text(st.to_json())
        self.settings = st
        api.compile_circuit(self.files["network.onnx"], self.files["settings.json"],
                            self.files["model.compiled"])
        self.gc = api.load_compiled(self.files["model.compiled"])
        self.k = self.gc.run_args.logrows
        self.srs = srsmod.gen_srs(self.k, seed=srs_seed(seed), device=device)
        self.inputs = rng_for(seed, "inputs")
        self.pk, _ = self.gc.setup([self.next_input()], self.srs, device=device)
        self.vk = self.pk.vk

    def next_input(self) -> np.ndarray:
        return draw_input(self.config, self.inputs)

    def srs_points(self, indices) -> list:
        """Affine (x, y) of the SRS's G1 points at `indices`, as integers."""
        from ezkl_tpu_torch.fieldmath import curve
        idx = list(indices)
        pts = self.srs.g1.map(lambda a: a[..., idx])
        return curve.decode_points(pts)

    def output_scale(self) -> int:
        return self.settings.model_output_scales[0]

    def free(self):
        """Drop the device state; the verifying key (host data) stays."""
        self.pk = self.srs = None


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Readings:
    """What a run measured, for the metrics' readers."""

    proofs: list            # per proof: {"wall_s", "phases"}
    window_s: float
    setup_s: float
    peak_window_bytes: int
    shapes: dict
    trace: dict | None = None


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unread"


def window(program: Program, entry, seconds: float, traffic: dict, device, trace: bool):
    """Drive the entry for `seconds`: one client, a fresh input per proof;
    a proof started inside the window finishes. With `trace`, the profiler
    records the first `trace_proofs` proofs of the traffic mix. Returns
    (records, window_s, peak bytes, profiler or None, traced proofs, their
    seconds)."""
    import torch
    from ezkl_tpu_torch.plonk import prover
    from .trace import WINDOW_RANGE

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    records = []
    prof = span = done = None
    traced, traced_s = 0, 0.0
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        prof.__enter__()
        span = torch.profiler.record_function(WINDOW_RANGE)
        span.__enter__()
    t0 = time.perf_counter()
    try:
        while not records or time.perf_counter() - t0 < seconds:
            x = program.next_input()
            prover.PHASE_SECONDS.clear()
            t1 = time.perf_counter()
            try:
                answer = entry.prove(x)
                error = None
            except Exception as e:          # a failed proof is counted, not fatal
                answer, error = None, f"{e.__class__.__name__}: {e}"
            if cuda:
                torch.cuda.synchronize(device)
            records.append({"x": x, "answer": answer, "error": error,
                            "wall_s": time.perf_counter() - t1,
                            "phases": dict(prover.PHASE_SECONDS)})
            if span is not None and len(records) == traffic["trace_proofs"]:
                span.__exit__(None, None, None)
                traced, traced_s = len(records), time.perf_counter() - t0
                prof.__exit__(None, None, None)
                span, prof, done = None, None, prof
        window_s = time.perf_counter() - t0
    finally:
        if span is not None:
            span.__exit__(None, None, None)
            traced, traced_s = len(records), time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            done = prof
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    return records, window_s, peak, done, traced, traced_s


def main(argv, started: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", help="run the program at a control setting of the "
                    "configuration (its `controls`); the reference stays as configured")
    ap.add_argument("--fault", help="plant a fault under the timed path (`faults.KINDS`)")
    args = ap.parse_args(argv)

    spec = load_spec()
    c = cell(spec, args.workload)
    # caches inside the checkout, at fixed paths
    os.environ["EZKL_TPU_CACHE"] = str(ROOT / ".cache" / "torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".cache" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("EZKL_TPU_DET_SEED", None)      # every proof gets real blinding

    import torch
    try:
        import ezkl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is missing ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {c.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    override = None
    if args.fault:
        from .faults import plant
        override = plant(args.fault)
    return run(c, args, device, started, entry_override=override)


def run(c: Cell, args, device, started: float, entry_override=None) -> int:
    """Set up, drive the window, judge and print. `entry_override` wraps the
    entry (tests plant faults with it)."""
    import torch

    from ezkl_tpu_torch.kernels import build
    lib_existed = (build.BUILD_DIR / build.LIB_NAME).exists()
    t_build = time.perf_counter()
    if device.type == "cuda":
        build.lib()
    build_s = time.perf_counter() - t_build
    with tempfile.TemporaryDirectory(prefix="benchmark-") as wd:
        program = Program(c.config, args.seed, pathlib.Path(wd), device,
                          control=getattr(args, "control", None))
        entry = entry_of(c.traffic).Entry(program, c.traffic)
        if entry_override is not None:
            entry = entry_override(entry)
        entry.prove(program.next_input())                 # the warm-up proof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        setup_s = time.perf_counter() - started
        records, window_s, peak, prof, traced, traced_s = window(
            program, entry, args.seconds, c.traffic, device, bool(args.trace))
        memory_peak = max(setup_peak, peak)
        srs_points = program.srs_points([0, 1, (1 << program.k) - 1])
        from . import work
        shapes = work.shapes(program.vk)
        trace = None
        if prof is not None:
            from .trace import reduce_profile
            trace = reduce_profile(prof, device)
            del prof
        for r in records:
            r["text"] = entry.answer_text(r["answer"]) if r["error"] is None else None
            r["answer"] = None
        entry.close()
        program.free()
        del entry
        if device.type == "cuda":
            torch.cuda.empty_cache()
        loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
        if loaded:
            print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
            return 4
        t_judge = time.perf_counter()
        from .correct import compare
        compared = compare(program, records, srs_points, c.config, c.traffic, args.seed)
        judge_s = time.perf_counter() - t_judge

    # a traced run's per-layer readings are of its traced proofs
    measured = records[:traced] if trace is not None else records
    readings = Readings(proofs=[r for r in measured if r["error"] is None],
                        window_s=traced_s if trace is not None else window_s,
                        setup_s=setup_s, peak_window_bytes=peak, shapes=shapes, trace=trace)
    wanted = c.per_layer if args.trace else c.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_reader(m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(r["error"] is not None for r in records)
    correct = failed == 0 and all(v["value"] <= v["limit"] for v in compared.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": c.chips, "memory_peak_bytes": memory_peak,
           "power_limit": _power_limit() if device.type == "cuda" else "n/a"}
    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    walls = [r["wall_s"] for r in records]
    print(json.dumps({"cell": c.name, "seed": args.seed, "build_s": build_s,
                      "library_was_built": not lib_existed, "setup_s": setup_s,
                      "proofs": len(records), "slowest_proof_s": max(walls),
                      "fastest_proof_s": min(walls), "window_s": window_s,
                      "reference_s": judge_s,
                      "errors": [r["error"] for r in records if r["error"]][:3]}), flush=True)
    result["compared"] = compared
    for name, v in compared.items():
        print(f"compared {name} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

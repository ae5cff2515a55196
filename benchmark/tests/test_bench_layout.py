"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries in BENCHMARK.json, and the harness finds them, with no
file that is already there edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from benchmark import harness

NEW_CONFIG = {"name": "mlp_8d", "source": "a wider MLP, for this test", "model": "mlp",
              "reduced": [], "input_shape": [1, 8],
              "input": {"kind": "uniform", "low": -1.0, "high": 1.0},
              "widths": [8, 8, 8], "weight_range": 1.0, "bias_range": 0.5,
              "run_args": {"input_scale": 7, "param_scale": 7,
                           "lookup_range": [-32768, 32768]}}
NEW_TRAFFIC = {"entry": "graph_prove", "loop": "closed", "clients": 1, "verify_sample": 2,
               "trace_proofs": 1}
NEW_METRIC = '''"""Per proof, seconds of phase 7 (for this test)."""

from ._phases import mean_phase

UNIT, SOURCE = "s", "program_span"
LAYER = "prover phases (plonk/prover.py, plonk/evaluator.py)"
MOVES = "prove_s"


def read(r):
    return mean_phase(r, "phase7: multiopen")
'''

PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
spec = harness.load_spec()
c = harness.cell(spec, "mlp_8d.short_loop")
r = harness.Readings(proofs=[{"wall_s": 1.0, "phases": {"phase7: multiopen": 0.5}}],
                     window_s=1.0, setup_s=1.0, peak_window_bytes=1, shapes={})
print(json.dumps({"root": str(harness.ROOT), "config": c.config["name"],
                  "entry": harness.entry_of(c.traffic).__name__,
                  "per_layer": [m["name"] for m in c.per_layer],
                  "value": harness.metric_reader("multiopen_s").read(r),
                  "forward": harness.model_of(c.config).__name__}))
"""


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_needs_only_new_files(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    before = _digests(tmp_path)
    (tmp_path / "benchmark" / "configs" / "mlp_8d.json").write_text(json.dumps(NEW_CONFIG))
    (tmp_path / "benchmark" / "traffic" / "short_loop.json").write_text(json.dumps(NEW_TRAFFIC))
    (tmp_path / "benchmark" / "metrics" / "multiopen_s.py").write_text(NEW_METRIC)
    spec["configs"].append({"name": "mlp_8d", "source": NEW_CONFIG["source"],
                            "file": "benchmark/configs/mlp_8d.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "mlp_8d.short_loop", "config": "mlp_8d",
                              "traffic": "short_loop", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "multiopen_s", "unit": "s", "better": "lower",
                              "source": "program_span", "moves": "prove_s",
                              "layer": "prover phases (plonk/prover.py, plonk/evaluator.py)",
                              "workloads": ["mlp_8d.short_loop"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    out = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path)], capture_output=True,
                         text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["root"] == str(tmp_path)
    assert got["config"] == "mlp_8d" and got["entry"] == "benchmark.entries.graph_prove"
    assert got["forward"] == "benchmark.models.mlp"
    assert "multiopen_s" in got["per_layer"] and got["value"] == 0.5


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has no
    program to measure: the run exits non-zero and prints no result."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mlp_4d.prove_loop", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout

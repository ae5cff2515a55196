"""The metrics' arithmetic, the trace's reduction, and the readers' agreement
with BENCHMARK.json."""

import ast
import pathlib

import pytest

from benchmark import harness, trace, work

METRICS = pathlib.Path(harness.BENCH) / "metrics"
SPEC = harness.load_spec()


def _readings(**kw):
    base = dict(proofs=[{"wall_s": 2.0, "phases": {"phase3: lookups m": 0.5,
                                                    "phase4: perm z + phi": 1.0}},
                        {"wall_s": 3.0, "phases": {"phase3: lookups m": 1.5,
                                                    "phase4: perm z + phi": 1.0,
                                                    "phase5: quotient": 0.25}}],
                window_s=5.5, setup_s=12.0, peak_window_bytes=3_000_000_000,
                shapes={"k": 13, "extended_k": 15, "num_fixed": 20, "num_advice": 3,
                        "num_instance": 1, "lookups": [[1, 1]] * 14, "shuffles": [],
                        "perm_columns": 4, "gate_products": 10, "gates": 6,
                        "rotations": [0, 1], "queries": 30},
                trace=None)
    base.update(kw)
    return harness.Readings(**base)


def test_end_to_end_arithmetic():
    r = _readings()
    assert harness.metric_reader("prove_s").read(r) == 2.75
    assert harness.metric_reader("peak_mem_gb").read(r) == 3.0
    assert harness.metric_reader("setup_s").read(r) == 12.0
    assert harness.metric_reader("prove_s").read(_readings(proofs=[])) is None


def test_phase_means_and_the_rest():
    r = _readings()
    assert harness.metric_reader("lookup_m_s").read(r) == 1.0
    assert harness.metric_reader("zphi_s").read(r) == 1.0
    assert harness.metric_reader("quotient_s").read(r) == 0.25       # one proof had it
    # (2 - 1.5) and (3 - 2.75)
    assert harness.metric_reader("outside_prover_s").read(r) == pytest.approx(0.375)


def test_trace_readers_are_silent_without_a_trace():
    r = _readings()
    for name in ("msm_roofline", "ntt_roofline", "device_idle_share", "prove_mfu"):
        assert harness.metric_reader(name).read(r) is None


def test_trace_readers():
    t = {"busy_s": 1.1, "window_s": 5.5,
         "ops_s": {"void scan_packed_kernel<2>(...)": 0.4, "void horner_kernel(...)": 0.1,
                   "void ntt_stages_kernel<Fr>(...)": 0.2, "aten::add": 3.0}}
    r = _readings(trace=t)
    assert harness.metric_reader("device_idle_share").read(r) == pytest.approx(80.0)
    msm = harness.metric_reader("msm_roofline").read(r)
    assert msm == pytest.approx(100 * work.msm_seconds(r.shapes) / 0.25)
    ntt = harness.metric_reader("ntt_roofline").read(r)
    assert ntt == pytest.approx(100 * work.transform_seconds(r.shapes) / 0.1)
    mfu = harness.metric_reader("prove_mfu").read(r)
    assert mfu == pytest.approx(100 * work.seconds_of(work.prove_products(r.shapes)) / 2.75)


def test_reduce_events():
    ms = 1_000_000
    ops = [(10 * ms, 20 * ms, "k1"), (15 * ms, 30 * ms, "k2"), (60 * ms, 70 * ms, "k1")]
    ranges = [(0, 40 * ms, "phase3: lookups m"), (40 * ms, 90 * ms, "phase4: perm z + phi")]
    t = trace.reduce_events(ops, ranges, (0, 100 * ms))
    assert t["busy_s"] == pytest.approx(0.030)                  # 10-30 and 60-70
    assert t["window_s"] == pytest.approx(0.100)
    assert t["ops_s"] == {"k1": pytest.approx(0.020), "k2": pytest.approx(0.015)}
    # idle 0-10 and 30-40 in phase 3, 40-60 and 70-90 in phase 4, 90-100 outside
    assert dict(t["idle_gaps"]) == {"phase3: lookups m": pytest.approx(0.020),
                                    "phase4: perm z + phi": pytest.approx(0.040),
                                    trace.OUTSIDE: pytest.approx(0.010)}
    assert t["device_ops"][0][0] == "k1"


def test_every_metric_has_a_reader_that_agrees_with_the_spec():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        mod = harness.metric_reader(m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"], m["name"]
        if m in SPEC["per_layer"]:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"], m["name"]
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    files = {p.stem for p in METRICS.glob("*.py") if not p.stem.startswith("_")}
    assert files == names


def test_no_reader_caps_a_share():
    for p in METRICS.glob("*.py"):
        tree = ast.parse(p.read_text())
        calls = [n.func.id for n in ast.walk(tree)
                 if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]
        assert "min" not in calls, p.name

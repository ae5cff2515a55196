"""Inputs, weights and the SRS's secret are made from the seed alone."""

import json

import numpy as np
import pytest

from benchmark import harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_inputs_and_weights_repeat_per_seed(workload):
    c = harness.cell(SPEC, workload)
    model = harness.model_of(c.config)
    for seed in (0, 12, 2**31 + 7, 2**40 + 3):
        a = [harness.draw_input(c.config, harness.rng_for(seed, "inputs")) for _ in range(2)]
        b = [harness.draw_input(c.config, harness.rng_for(seed, "inputs")) for _ in range(2)]
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        wa = model.draw_weights(c.config, harness.rng_for(seed, "weights"))
        wb = model.draw_weights(c.config, harness.rng_for(seed, "weights"))
        assert all(np.array_equal(wa[k], wb[k]) for k in wa)
        assert model.build(c.config, wa) == model.build(c.config, wb)
    one = harness.draw_input(c.config, harness.rng_for(5, "inputs"))
    two = harness.draw_input(c.config, harness.rng_for(6, "inputs"))
    assert not np.array_equal(one, two)


@pytest.mark.parametrize("workload", CELLS)
def test_inputs_keep_the_configured_shape_and_range(workload):
    c = harness.cell(SPEC, workload)
    rng = harness.rng_for(99, "inputs")
    spec = c.config["input"]
    for _ in range(50):
        x = harness.draw_input(c.config, rng)
        assert x.shape == tuple(c.config["input_shape"])
        assert spec["low"] <= x.min() and x.max() < spec["high"]
        if spec["kind"] == "integers":
            assert np.array_equal(x, np.round(x))


def test_srs_secret_repeats_and_differs():
    assert harness.srs_tau(3) == harness.srs_tau(3)
    assert harness.srs_tau(3) != harness.srs_tau(4)
    from benchmark.reference.bn254 import R
    assert 0 < harness.srs_tau(2**31 + 9) < R


@pytest.mark.parametrize("workload", CELLS)
def test_traffic_names_an_entry(workload):
    c = harness.cell(SPEC, workload)
    entry = harness.entry_of(c.traffic)
    assert hasattr(entry, "Entry")
    assert c.traffic["loop"] == "closed" and c.traffic["clients"] == 1
    assert c.traffic["verify_sample"] >= 1 and c.traffic["trace_proofs"] >= 1


def test_configs_match_their_entries():
    for conf in SPEC["configs"]:
        cfg = json.loads((harness.ROOT / conf["file"]).read_text())
        assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
        assert cfg["reduced"] == conf["reduced"]

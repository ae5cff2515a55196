"""The `moonlight_mla_head_s8` configuration: its cell and its metric load
through the harness, and the benchmark's fixed-point forward of the MLA head
equals the test suite's PyTorch reference (`tests/torch_port_mla_reference.py`)
on the same seed, at the published widths."""

import sys

import numpy as np
import pytest
import torch

from benchmark import harness

CELL = "moonlight_mla_head_s8.prove_loop"


def test_the_cell_and_its_metric_load():
    c = harness.cell(harness.load_spec(), CELL)
    assert c.config["name"] == "moonlight_mla_head_s8" and c.chips == 1
    assert harness.model_of(c.config).__name__ == "benchmark.models.mla_head"
    assert harness.entry_of(c.traffic).__name__ == "benchmark.entries.graph_prove"
    assert {m["name"] for m in c.end_to_end} == {"prove_s", "setup_s"}
    assert "freivalds_s" in {m["name"] for m in c.per_layer}
    reader = harness.metric_reader("freivalds_s")
    r = harness.Readings(proofs=[{"wall_s": 3.0, "phases": {"phase2b: freivalds witness": 1.5}},
                                 {"wall_s": 3.0, "phases": {"phase2b: freivalds witness": 2.5}}],
                         window_s=6.0, setup_s=1.0, peak_window_bytes=0, shapes={})
    assert reader.read(r) == 2.0
    r.proofs = [{"wall_s": 3.0, "phases": {"phase2: advice commitments": 1.0}}]
    assert reader.read(r) is None            # a program without the span


@pytest.mark.parametrize("seed", [5, 2**31 + 29])
def test_forward_equals_the_test_suites_reference(seed):
    sys.path.insert(0, str(harness.ROOT / "tests"))
    import torch_port_mla_reference as ref

    config = harness.cell(harness.load_spec(), CELL).config
    model = harness.model_of(config)
    weights = model.draw_weights(config, harness.rng_for(seed, "weights"))
    rng = harness.rng_for(seed, "inputs")
    s = config["run_args"]["input_scale"]
    w = {k: torch.from_numpy(v) for k, v in weights.items()}
    for _ in range(2):
        x = harness.draw_input(config, rng)
        want = ref.head_fixed(torch.from_numpy(x), w, ref.dims_of(config), s, s)
        assert np.array_equal(model.forward(config, weights, x, s, s), want.reshape(-1).numpy())

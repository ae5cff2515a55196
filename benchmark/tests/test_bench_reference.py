"""The plain reference: its fixed-point forward gives the program's outputs,
and its verifier accepts the program's proof and rejects altered ones. On the
CPU, at tiny size (a CPU proof takes tens of seconds)."""

import copy
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import verifier

SPEC = harness.load_spec()
TINY = json.loads((pathlib.Path(__file__).parent / "tiny_mlp.json").read_text())
CONFIGS = {c["name"]: json.loads((harness.ROOT / c["file"]).read_text())
           for c in SPEC["configs"]}


def _program_outputs(config, weights, xs, scales):
    from ezkl_tpu_torch import api
    from ezkl_tpu_torch.graph.run_args import RunArgs
    import tempfile
    model = harness.model_of(config)
    with tempfile.TemporaryDirectory() as d:
        d = pathlib.Path(d)
        (d / "m.onnx").write_bytes(model.build(config, weights))
        ra = dict(config["run_args"], input_scale=scales, param_scale=scales)
        ra["lookup_range"] = tuple(ra["lookup_range"])
        api.gen_settings(str(d / "m.onnx"), str(d / "s.json"), RunArgs(**ra))
        api.compile_circuit(str(d / "m.onnx"), str(d / "s.json"), str(d / "c.json"))
        gc = api.load_compiled(str(d / "c.json"))
        outs = []
        for x in xs:
            _, _, tvs = gc.forward([x])
            outs.append(np.concatenate([t.ints.reshape(-1) for t in tvs]))
        return outs


@pytest.mark.parametrize("name", sorted(CONFIGS) + ["tiny_mlp"])
@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_forward_gives_the_program_outputs(name, seed):
    config = TINY if name == "tiny_mlp" else CONFIGS[name]
    model = harness.model_of(config)
    weights = model.draw_weights(config, harness.rng_for(seed, "weights"))
    rng = harness.rng_for(seed, "inputs")
    xs = [harness.draw_input(config, rng) for _ in range(4)]
    s = config["run_args"]["input_scale"]
    got = _program_outputs(config, weights, xs, s)
    for x, g in zip(xs, got):
        assert np.array_equal(model.forward(config, weights, x, s, s), g)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_lower_scale_gives_other_outputs(name):
    """The control's precision (one bit less) changes the outputs."""
    config = CONFIGS[name]
    model = harness.model_of(config)
    weights = model.draw_weights(config, harness.rng_for(3, "weights"))
    rng = harness.rng_for(3, "inputs")
    low = config["controls"]["scale6"]["input_scale"]
    s = config["run_args"]["input_scale"]
    gaps = []
    for _ in range(8):
        x = harness.draw_input(config, rng)
        a = model.forward(config, weights, x, s, s)
        b = model.forward(config, weights, x, low, low) * 2 ** (s - low)
        gaps.append(np.abs(a - b).max())
    assert max(gaps) >= 1


@pytest.fixture(scope="module")
def tiny_proof():
    """One tiny circuit keyed and proved by the program on the CPU."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        seed = 77
        program = harness.Program(TINY, seed, pathlib.Path(d), torch.device("cpu"))
        x = program.next_input()
        proof, _ = program.gc.prove([x], program.srs, pk=program.pk)
        yield {"circuit": verifier.circuit_of(program.vk), "tau": harness.srs_tau(seed),
               "proof": verifier.parse_proof(proof.to_json()), "x": x, "program": program}


def test_reference_verifier_accepts_the_proof(tiny_proof):
    assert verifier.verify(tiny_proof["circuit"], tiny_proof["proof"], tiny_proof["tau"])


@pytest.mark.parametrize("fault", ["eval", "instance", "commitment", "opening", "tau"])
def test_reference_verifier_rejects_an_altered_proof(tiny_proof, fault):
    proof = copy.deepcopy(tiny_proof["proof"])
    tau = tiny_proof["tau"]
    if fault == "eval":
        label = sorted(proof["evals"])[0]
        proof["evals"][label] ^= 1
    elif fault == "instance":
        proof["instances"][0][0] = (proof["instances"][0][0] + 1) % verifier.R
    elif fault == "commitment":
        proof["advice"][0], proof["advice"][1] = proof["advice"][1], proof["advice"][0]
    elif fault == "opening":
        proof["openings"][0] = proof["openings"][-1]
    else:
        tau += 1
    assert not verifier.verify(tiny_proof["circuit"], proof, tau)

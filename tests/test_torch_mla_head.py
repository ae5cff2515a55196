"""One head of a DeepSeek-V3-style latent attention (MLA) layer through the
port's graph path on the CPU, held to the plain PyTorch references of
`torch_port_mla_reference`.

At small widths (hidden 64, latent 32, nope 16, rope 8, v 16, 2 heads, 4
positions, seeded weights), with the ONNX graph that the benchmark's
`moonlight_mla_head_s8` configuration proves at its published widths
(`benchmark/models/mla_head.py`):
* gen_settings -> compile_circuit -> gen_witness -> mock gives outputs equal
  to the int64 fixed-point reference, exactly, for each head;
* the fixed-point reference stays within a tolerance of the float32 head;
* the heads' parts summed equal the whole float32 layer computed as one block.

A CPU keygen and proof of the head takes too long for these tests (k = 15
at these widths; the plain MSM over its fixed columns runs for minutes at
k >= 11), so the prover's phase spans are checked on one proof of a small
circuit that lays a Freivalds argument by itself, at k = 6.
"""

import json

import numpy as np
import pytest
import torch

from benchmark.models import mla_head
from ezkl_tpu_torch import api
from ezkl_tpu_torch.fieldmath.spec import FR_MODULUS
from ezkl_tpu_torch.graph.run_args import RunArgs

import torch_port_mla_reference as ref

torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core

HEADS = 2
CONFIG = {"input_shape": [4, 64 + 32 + 8], "hidden_size": 64, "kv_lora_rank": 32,
          "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
          "rope_theta": 50000, "rms_norm_eps": 1e-05, "mask_value": -20}
DIMS = ref.dims_of(CONFIG)
STD = {"q": 0.12, "kv_b": 0.12, "o": 0.15}
# scale 7 as the benchmark's configuration; the table range holds the
# masked scores (-20 * 2^7) and the softmax's row sums
RUN_ARGS = {"input_scale": 7, "param_scale": 7, "lookup_range": (-8192, 8192)}
# relative L2 gap of the fixed-point head to the float32 head over 8 inputs
# and both heads: every step rounds at 2^-7 (the folded W_q, std 0.025, to a
# third of its own size), which reads 0.036-0.053 over 30 weight seeds at
# scale 7 and 0.075-0.105 at scale 6, a bit less
FIXED_VS_FLOAT = 0.065


def _layer(seed):
    return ref.draw_layer(DIMS, HEADS, seed, STD)


def _inputs(seed, n):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(DIMS["S"], CONFIG["input_shape"][1], generator=g,
                       dtype=torch.float64) * 3.5 - 1.75 for _ in range(n)]


def _signed(hexes):
    v = [int(h, 16) for h in hexes]
    return np.array([x - FR_MODULUS if x > FR_MODULUS // 2 else x for x in v], np.int64)


@pytest.mark.parametrize("head", range(HEADS))
def test_port_outputs_equal_the_fixed_point_reference(tmp_path, head):
    w = ref.head_weights(*_layer(5), head, DIMS)
    (x,) = _inputs(50 + head, 1)
    f = {k: str(tmp_path / k) for k in ("net.onnx", "settings.json", "model.compiled",
                                         "input.json", "witness.json")}
    (tmp_path / "net.onnx").write_bytes(
        mla_head.build(CONFIG, {k: v.numpy() for k, v in w.items()}))
    (tmp_path / "input.json").write_text(json.dumps({"input_data": [x.reshape(-1).tolist()]}))
    st = api.gen_settings(f["net.onnx"], f["settings.json"], RunArgs(**RUN_ARGS))
    assert st.model_output_scales == [RUN_ARGS["input_scale"]]
    api.compile_circuit(f["net.onnx"], f["settings.json"], f["model.compiled"])
    wit = api.gen_witness(f["model.compiled"], f["input.json"], f["witness.json"], device="cpu")
    want = ref.head_fixed(x, w, DIMS, RUN_ARGS["input_scale"], RUN_ARGS["param_scale"])
    assert np.array_equal(_signed(wit["outputs"][0]), want.reshape(-1).numpy())
    assert api.mock(f["model.compiled"], f["input.json"], device="cpu")


@pytest.mark.parametrize("scale", [7, 6])
def test_fixed_point_head_is_near_the_float_head(scale):
    """Within FIXED_VS_FLOAT at the configured scale 7; one bit less is not."""
    layer = _layer(7)
    num = den = 0.0
    for x in _inputs(70, 8):
        for head in range(HEADS):
            w = ref.head_weights(*layer, head, DIMS)
            f = ref.head_float(x, w, DIMS).double()
            y = ref.head_fixed(x, w, DIMS, scale, scale).double() / 2 ** scale
            num += float(((y - f) ** 2).sum())
            den += float((f ** 2).sum())
    gap = (num / den) ** 0.5
    assert (gap <= FIXED_VS_FLOAT) == (scale == 7), gap


def test_heads_sum_to_the_whole_layer():
    """The share of each of the layer's tensor-parallel provers: the heads'
    outputs, each from its own weight slices, add up to the uncut layer.
    Tolerance: float32 rounding of the folded scale and of the sum's order."""
    layer = _layer(9)
    for x in _inputs(90, 3):
        whole = ref.layer_float(x, *layer, DIMS)
        parts = sum(ref.head_float(x, ref.head_weights(*layer, h, DIMS), DIMS)
                    for h in range(HEADS))
        torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-5)


def test_the_mask_zeroes_future_positions_exactly():
    """exp(mask + score) at scale 7 rounds to 0: row i of the fixed-point
    head does not move when a later position's input changes."""
    w = ref.head_weights(*_layer(11), 0, DIMS)
    (x,) = _inputs(110, 1)
    y = ref.head_fixed(x, w, DIMS, 7, 7)
    x2 = x.clone()
    x2[-1] = -x2[-1]
    y2 = ref.head_fixed(x2, w, DIMS, 7, 7)
    assert torch.equal(y[:-1], y2[:-1]) and not torch.equal(y[-1], y2[-1])


def test_prover_phases_are_unique_disjoint_with_the_freivalds_witness(monkeypatch):
    """One CPU proof of a circuit with a Freivalds argument: its phase ranges
    (the `torch.profiler` ranges that `_span` opens, which the benchmark's
    trace reads) are uniquely named and do not overlap, `phase2b` is among
    them, their seconds are `PHASE_SECONDS`, and the module counts the
    argument's rows. Evaluating phase 6 in groups of columns leaves the
    proof's bytes as they were."""
    import time

    from ezkl_tpu_torch.graph.layout import BaseConfig, LayoutCtx, TVal
    from ezkl_tpu_torch.graph.modules import get_freivalds
    from ezkl_tpu_torch.plonk import keygen, prover, srs as srsmod, verifier

    ranges = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            ranges.append((self.t0, time.perf_counter(), self.name))

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    rng = np.random.default_rng(3)
    M, K, N = 2, 3, 2
    a = rng.integers(-8, 8, (M, K))
    b = rng.integers(-8, 8, (K, N))
    cfg = BaseConfig()
    ctx = LayoutCtx(cfg, 6)
    fre = get_freivalds(cfg)
    fre.matmul(ctx, TVal(a, 0, None, witness=True), TVal(b, 0, None), a @ b)
    assert (fre.rlc_rows, fre.dot_rows) == (K * N + M * N, M * K)
    asg = ctx.finalize()
    srs = srsmod.gen_srs(6, device="cpu")
    pk = keygen.keygen(cfg.cs, 6, srs, asg, device="cpu")
    proof = prover.create_proof(pk, srs, asg, seed=1)
    assert verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
    first, seconds = list(ranges), dict(prover.PHASE_SECONDS)
    names = [n for _, _, n in first]
    # phase 6 evaluating two columns at a time gives the same proof
    monkeypatch.setattr(prover, "EVAL_GROUP_ELEMENTS", 2 << 6)
    assert prover.create_proof(pk, srs, asg, seed=1).to_json() == proof.to_json()
    assert names[:4] == ["phase1: bind vk+instances", "phase2: advice commitments",
                         "phase2b: freivalds witness", "phase2c: phase-1 commitments"]
    assert len(set(names)) == len(names)
    spans = sorted(first)
    assert all(hi <= nxt for (_, hi, _), (nxt, _, _) in zip(spans, spans[1:]))
    assert set(seconds) == set(names)

"""The small ONNX models that the port's graph and API tests run.

Each model is built with an `onnx_writer` module passed in (the JAX
package's or the port's), so the tests can hold the two writers' bytes equal
and feed either package the same file. Every builder draws its weights and
its input from its own `numpy.random.default_rng` seed.

`MODELS[name]` is `(build, run_args)`: `build(writer)` returns
`(onnx_bytes, input_json_dict)`, and `run_args` holds the RunArgs fields that
differ from the defaults. mlp_4d settles on k = 8 and the other three on
k = 9, so the JAX prover compiles for two domain sizes when the fixtures are
frozen (`tools/make_torch_fixtures.py --part graph`). The run arguments
follow the tiny-model recipe: small scales, `decomp_base=32` and a narrow
`lookup_range`, whose 513-row ReLU table is larger than the usable rows at
k = 8 and 9 (249 and 505), so it splits into column sets (chunks).
"""

from __future__ import annotations

import numpy as np

# the graded mlp_4d of `examples/gen_graded.py`, which `chip_smoke.py`'s
# graph phase proves on the card
from chip_smoke import mlp_4d  # noqa: F401

_SMALL = {
    "input_scale": 2,
    "param_scale": 2,
    "lookup_range": (-256, 256),
    "decomp_base": 32,
}


def _input(x) -> dict:
    return {"input_data": [np.asarray(x, np.float64).reshape(-1).tolist()]}


def conv_small(w):
    """conv -> relu -> average pool -> flatten -> gemm, the op list of the
    graded `conv2d_mnist`, on a 1x1x8x8 input."""
    rng = np.random.default_rng(7)
    k = rng.uniform(-0.5, 0.5, (1, 1, 3, 3)).astype(np.float32)
    kb = rng.uniform(-0.25, 0.25, (1,)).astype(np.float32)
    # 8x8 -> conv 3x3 stride 2 -> 3x3 -> pool 2x2 stride 1 -> 2x2 -> 4
    fcw = rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32)
    fcb = rng.uniform(-0.25, 0.25, (3,)).astype(np.float32)
    nodes = [
        w.node("Conv", ["x", "k", "kb"], ["c0"], name="conv",
               kernel_shape=[3, 3], strides=[2, 2], pads=[0, 0, 0, 0]),
        w.node("Relu", ["c0"], ["a0"], name="relu0"),
        w.node("AveragePool", ["a0"], ["p0"], name="pool",
               kernel_shape=[2, 2], strides=[1, 1]),
        w.node("Flatten", ["p0"], ["f0"], name="flat"),
        w.node("Gemm", ["f0", "fcw", "fcb"], ["y"], name="fc"),
    ]
    onnx = w.model(nodes, {"x": (1, 1, 8, 8)}, {"y": (1, 3)},
                   {"k": k, "kb": kb, "fcw": fcw, "fcb": fcb})
    x = rng.integers(0, 4, (1, 1, 8, 8)).astype(np.float64)
    return onnx, _input(x)


def gemm_freivalds(w):
    """A 4x9 @ 9x16 MatMul, then Relu: M*N*K = 576 > 2*(K*N + M*N + M*K) =
    488 and > 512, so the layout proves the product with Freivalds' check
    and a second-phase advice column (`graph/model.py`, `_matmul`)."""
    rng = np.random.default_rng(11)
    b = rng.uniform(-1, 1, (9, 16)).astype(np.float32)
    nodes = [w.node("MatMul", ["x", "b"], ["h"], name="mm"),
             w.node("Relu", ["h"], ["y"], name="relu")]
    onnx = w.model(nodes, {"x": (4, 9)}, {"y": (4, 16)}, {"b": b})
    x = rng.uniform(-1, 1, (4, 9)).astype(np.float64)
    return onnx, _input(x)


# conv_small and gemm_freivalds skip the inputs' range check on entry (a
# reference run argument) and gemm_freivalds keeps the product's scale, so
# that both fit in 2^9 rows; mlp_4d keeps the check
_UNCHECKED = dict(_SMALL, ignore_range_check_inputs_outputs=True)

MODELS = {
    "mlp_4d": (mlp_4d, dict(_SMALL)),
    "conv_small": (conv_small, _UNCHECKED),
    "gemm_freivalds": (gemm_freivalds, dict(_UNCHECKED, scale_rebase_multiplier=2)),
    # the mlp_4d graph with a Poseidon-hashed input and KZG-committed
    # params: an in-circuit hash module and unblinded columns committed at
    # witness time
    "mlp_4d_hashed": (mlp_4d, dict(_SMALL, input_visibility="hashed",
                                   param_visibility="kzgcommit")),
}


def run_args(run_args_cls, name: str):
    """The model's RunArgs, built with the given package's class."""
    return run_args_cls(**MODELS[name][1]).validate()

"""A ReLU MLP: Gemm (+ bias), ReLU, per layer. ezkl's
`examples/mlp_4d_einsum.rs` lays out 4 -> 4 -> 4 with a ReLU after each
affine layer.

`build` writes the ONNX model (each weight stored as Gemm's B, that is
transposed); `forward` is the plain reference in numpy int64 at the run
arguments' fixed-point scales, rounding as `conv2d.forward` says. It
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from .. import onnx_writer as w
from .fixed import quantize, rounded_div


def draw_weights(cfg: dict, rng: np.random.Generator) -> dict:
    out = {}
    widths = cfg["widths"]
    for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
        wt = rng.uniform(-cfg["weight_range"], cfg["weight_range"], (n_out, n_in))
        out[f"w{i}"] = wt.astype(np.float32).T.copy()
        out[f"b{i}"] = rng.uniform(-cfg["bias_range"], cfg["bias_range"],
                                   (n_out,)).astype(np.float32)
    return out


def build(cfg: dict, weights: dict) -> bytes:
    nodes = []
    layers = len(cfg["widths"]) - 1
    src = "x"
    for i in range(layers):
        out = "y" if i == layers - 1 else f"a{i}"
        nodes.append(w.node("Gemm", [src, f"w{i}", f"b{i}"], [f"h{i}"], name=f"l{i}"))
        nodes.append(w.node("Relu", [f"h{i}"], [out], name=f"relu{i}"))
        src = out
    return w.model(nodes, {"x": tuple(cfg["input_shape"])}, {"y": (1, cfg["widths"][-1])},
                   weights)


def forward(cfg: dict, weights: dict, x: np.ndarray, input_scale: int,
            param_scale: int) -> np.ndarray:
    """The quantized outputs at scale `input_scale` (int64, flat)."""
    h = quantize(x, input_scale).reshape(-1)
    for i in range(len(cfg["widths"]) - 1):
        wq = quantize(weights[f"w{i}"], param_scale)
        bq = quantize(weights[f"b{i}"], param_scale) << input_scale
        h = np.maximum(rounded_div(h @ wq + bq, 1 << param_scale), 0)
    return h

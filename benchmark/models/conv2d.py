"""A one-conv MNIST classifier: Conv (stride, no padding) + bias, ReLU, a
sum pool written as AveragePool, Flatten, Gemm. ezkl's
`examples/conv2d_mnist/main.rs` lays out the same network.

`build` writes the ONNX model from the configuration's sizes and a seeded
generator; `forward` is the plain reference: the same network in numpy
int64 at the fixed-point scales of the run arguments, rounding as a
fixed-point circuit of ezkl's kind does (inputs and weights rounded half to
even at 2^scale, biases at the product's scale, each product rebased by a
rounded division by 2^scale, the pool's mean by a rounded division by its
area). It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from .. import onnx_writer as w
from .fixed import quantize, rounded_div


def draw_weights(cfg: dict, rng: np.random.Generator) -> dict:
    conv, fc = cfg["conv"], cfg["fc"]
    c_in = cfg["input_shape"][1]
    oh = (cfg["input_shape"][2] - conv["kernel"]) // conv["stride"] + 1
    ph = oh - cfg["pool"]["kernel"] + 1
    kk = conv["kernel"]
    return {
        "k": rng.uniform(-conv["weight_range"], conv["weight_range"],
                         (conv["out_channels"], c_in, kk, kk)).astype(np.float32),
        "kb": rng.uniform(-conv["bias_range"], conv["bias_range"],
                          (conv["out_channels"],)).astype(np.float32),
        "fcw": rng.uniform(-fc["weight_range"], fc["weight_range"],
                           (conv["out_channels"] * ph * ph, fc["out"])).astype(np.float32),
        "fcb": rng.uniform(-fc["bias_range"], fc["bias_range"], (fc["out"],)).astype(np.float32),
    }


def build(cfg: dict, weights: dict) -> bytes:
    conv, pool = cfg["conv"], cfg["pool"]
    nodes = [
        w.node("Conv", ["x", "k", "kb"], ["c0"], name="conv",
               kernel_shape=[conv["kernel"]] * 2, strides=[conv["stride"]] * 2,
               pads=[0, 0, 0, 0]),
        w.node("Relu", ["c0"], ["a0"], name="relu0"),
        w.node("AveragePool", ["a0"], ["p0"], name="pool",
               kernel_shape=[pool["kernel"]] * 2, strides=[pool["stride"]] * 2),
        w.node("Flatten", ["p0"], ["f0"], name="flat"),
        w.node("Gemm", ["f0", "fcw", "fcb"], ["y"], name="fc"),
    ]
    return w.model(nodes, {"x": tuple(cfg["input_shape"])}, {"y": (1, cfg["fc"]["out"])},
                   weights)


def forward(cfg: dict, weights: dict, x: np.ndarray, input_scale: int,
            param_scale: int) -> np.ndarray:
    """The quantized outputs at scale `input_scale` (int64, flat)."""
    conv, pool = cfg["conv"], cfg["pool"]
    s = conv["stride"]
    kk = conv["kernel"]
    xq = quantize(x, input_scale)[0]                              # (C, H, W)
    kq = quantize(weights["k"], param_scale)                      # (O, C, kk, kk)
    kbq = quantize(weights["kb"], param_scale) << input_scale
    oh = (xq.shape[1] - kk) // s + 1
    ow = (xq.shape[2] - kk) // s + 1
    c = np.empty((kq.shape[0], oh, ow), np.int64)
    for i in range(oh):
        for j in range(ow):
            patch = xq[:, s * i:s * i + kk, s * j:s * j + kk]
            c[:, i, j] = np.tensordot(kq, patch, axes=([1, 2, 3], [0, 1, 2]))
    c = rounded_div(c + kbq[:, None, None], 1 << param_scale)
    a = np.maximum(c, 0)
    pk, ps = pool["kernel"], pool["stride"]
    ph = (a.shape[1] - pk) // ps + 1
    pw = (a.shape[2] - pk) // ps + 1
    summed = np.zeros((a.shape[0], ph, pw), np.int64)
    for di in range(pk):
        for dj in range(pk):
            summed += a[:, di:di + ps * ph:ps, dj:dj + ps * pw:ps]
    p = rounded_div(summed, pk * pk)
    fcw = quantize(weights["fcw"], param_scale)
    fcb = quantize(weights["fcb"], param_scale) << input_scale
    y = p.reshape(-1) @ fcw + fcb
    return rounded_div(y, 1 << param_scale)

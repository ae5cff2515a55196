"""Graph layer: ONNX -> quantized circuit compiler (port of `ezkl_tpu/graph/`,
which is pure numpy: its modules are copied with their imports rewired to
the port's `plonk`, `kernels` and package modules)."""

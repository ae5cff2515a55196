"""ezkl_tpu_torch — the PyTorch/CUDA port of `ezkl_tpu` for one NVIDIA H100.

ONNX model -> quantized PLONKish circuit over BN254 -> witness -> keygen ->
KZG proof -> verification, with the JAX package's API, CLI
(`python -m ezkl_tpu_torch`) and artifact formats. The device work runs in
hand-written CUDA kernels (`csrc/`); entry points run on the card unless
the caller passes `device="cpu"`.
"""

import os as _os
import pathlib as _pathlib


def cache_dir() -> str:
    """The port's cache directory (the lookup-table cache lives under it,
    `graph/ops.py`): `$EZKL_TPU_CACHE`, else `.cache/torch` in a source
    checkout, else `~/.ezkl-tpu/torch-cache`. The port compiles no JAX
    programs, so unlike the JAX package's it is not keyed by backend."""
    repo_root = _pathlib.Path(__file__).resolve().parent.parent
    default = (repo_root / ".cache" / "torch"
               if (repo_root / "pyproject.toml").exists()
               else _pathlib.Path.home() / ".ezkl-tpu" / "torch-cache")
    return _os.environ.get("EZKL_TPU_CACHE", str(default))

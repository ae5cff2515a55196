"""Build and load the port's CUDA kernels (`ezkl_tpu_torch/csrc/*.cu`).

The sources are compiled with `nvcc` for `sm_90a` at first use, one `nvcc -c`
per source started together, then linked into
`build/ezkl_tpu_torch/libbn254.so` at the repo root and loaded with ctypes.
Each C entry takes data pointers, an element count and a CUDA stream and
returns `cudaGetLastError()`; `check` turns a non-zero value into an error.
Nothing here falls back: a missing `nvcc` or a failed build raises.

`LAUNCHES` counts the kernel launches of each wrapper: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels. `WIDTHS` keeps, beside it, the width and
the Montgomery products of each launch of K1 (`mont_mul`, `mont_pow`,
`mont_scan`), K2 (`ntt_stages`), K3 (`point_add`, `point_reduce`), K9
(`point_dbl`) and the fused MSM's K4-K8, so a run can also show how wide
they were.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "ezkl_tpu_torch"
LIB_NAME = "libbn254.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

LAUNCHES = {"mont_mul": 0, "mont_pow": 0, "mont_scan": 0, "ntt_stages": 0, "point_add": 0,
            "point_reduce": 0, "point_dbl": 0, "scan_packed": 0, "scan_steps": 0,
            "fold_lanes": 0, "dbl_pow2": 0, "horner": 0}

# (kernel, field, elements, products) of every K1 (`mont_mul`, `mont_pow`,
# `mont_scan`), K2 (`ntt_stages`), K3 (`point_add`, `point_reduce`; field
# bn254_fq, elements = lanes in, products = 12 per add) and K9 (`point_dbl`,
# products = 8 per lane) launch, and
# (kernel, field, lanes, products, bytes) of every K4-K8 launch (`scan_packed`,
# `scan_steps`, `fold_lanes`, `dbl_pow2`, `horner`: lanes = point chains,
# bytes = each input read and each output written once), since the last
# `reset_launches`, in launch order; bounded (a k = 14 prove made about 6,000
# of them when every product of a chain was a `mont_mul` launch).
WIDTHS: collections.deque = collections.deque(maxlen=1 << 16)

_LIB = None

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "ez_mont_mul": [_I, _VP, _VP, _VP, _LL, _LL, _LL, _VP],
    "ez_mont_pow": [_I, _VP, _VP, _LL, _VP, _VP, _I, _I, _I, _VP],
    "ez_mont_scan": [_I, _VP, _VP, _LL, _I, _VP],
    "ez_ntt_stages": [_I, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _VP],
    "ez_point_add": [_VP] * 9 + [_LL, _I, _VP],
    "ez_point_reduce": [_VP] * 6 + [_LL, _I, _VP],
    "ez_point_dbl": [_VP] * 6 + [_LL, _I, _VP],
    "ez_scan_packed": [_VP] * 6 + [_LL, _I, _I, _VP],
    "ez_scan_steps": [_I] + [_VP] * 6 + [_LL, _I, _I, _VP],
    "ez_fold_lanes": [_I] + [_VP] * 6 + [_LL, _I, _I, _I, _VP],
    "ez_dbl_pow2": [_VP] * 6 + [_LL, _I, _VP],
    "ez_horner": [_VP] * 6 + [_I, _I, _LL, _VP],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    WIDTHS.clear()


def width_histogram(widths=None) -> dict:
    """Launches per kernel, field and power-of-two width (the least power of
    two >= the launch's element count), from `WIDTHS`:
    {"mont_mul/bn254_fr": {"2^14": count, ...}, ...}."""
    hist = collections.defaultdict(collections.Counter)
    for name, field, n, *_ in WIDTHS if widths is None else widths:
        hist[f"{name}/{field}"][f"2^{(n - 1).bit_length()}"] += 1
    return {k: dict(sorted(v.items(), key=lambda kv: int(kv[0][2:])))
            for k, v in sorted(hist.items())}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    cus, cuhs = _sources()
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH).encode())
    return h.hexdigest()


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels unless `build/` already holds them for these
    exact sources. Returns the library path; raises on any failure."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _digest()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    flags = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", f"-I{CSRC}"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    procs = []
    for cu in cus:
        obj = BUILD_DIR / (cu.stem + ".o")
        procs.append((cu, obj, subprocess.Popen(
            [nvcc, *flags, "-c", str(cu), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cu, _, p in procs:
        out, _ = p.communicate()
        if verbose and out:
            print(out, flush=True)
        if p.returncode != 0:
            failed.append(f"{cu.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout)
    tmp.replace(lib_path)
    stamp.write_text(digest)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_card(name: str, *tensors, same_width: bool = True, ndim: int = 2):
    """The checks every kernel wrapper makes before it launches: limb
    tensors (8, *batch) of `ndim` dims, contiguous, on one card."""
    import torch
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all operands must be on one CUDA device")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: operands must be int32 limb tensors")
        if t.dim() != ndim or t.shape[0] != 8 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous {ndim}-d (8, ...)")
        if same_width and t.shape[1:] != tensors[0].shape[1:]:
            raise ValueError(f"{name}: operand shapes differ")

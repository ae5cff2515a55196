"""ctypes loader for the native host-crypto library (`native/host_crypto.cpp`).

The C++ module is the native twin of `hostcurve.py` + `plonk/pairing.py`
— BN254 Fq Montgomery arithmetic, G1 ops, optimal ate pairing — used on
the verifier/keygen host path (the part the reference runs as native Rust
via halo2curves). ~10-50x over the Python-bigint fallback; `verify` drops
from ~0.5-1 s to tens of ms.

Loading: a prebuilt `native/libezkl_host.so` is used if present;
otherwise one `make` build is attempted (g++ is in the image). Failures
fall back to pure Python silently — the library is an accelerator, never
a requirement. Env: EZKL_TPU_NATIVE=0 disables it.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

_LIB = None
_TRIED = False

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "native"
_SO = _NATIVE_DIR / "libezkl_host.so"


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("EZKL_TPU_NATIVE", "1") in ("0", "false"):
        return None
    if not _SO.exists() and (_NATIVE_DIR / "host_crypto.cpp").exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    if not _SO.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
        lib.ez_g1_add.restype = ctypes.c_int
        lib.ez_g1_mul.restype = ctypes.c_int
        lib.ez_g1_msm.restype = ctypes.c_int
        lib.ez_pairing_check.restype = ctypes.c_int
        if lib.ez_version() != 1:
            return None
        _LIB = lib
    except OSError:
        return None
    return _LIB


def available() -> bool:
    return _load() is not None


def _pt_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return int(pt[0]).to_bytes(32, "little") + int(pt[1]).to_bytes(32, "little")


def _pt_from(buf: bytes):
    if buf == b"\x00" * 64:
        return None
    return (int.from_bytes(buf[:32], "little"),
            int.from_bytes(buf[32:64], "little"))


def g1_add(a, b):
    lib = _load()
    out = ctypes.create_string_buffer(64)
    rc = lib.ez_g1_add(_pt_bytes(a), _pt_bytes(b), out)
    if rc != 0:
        raise ValueError("g1_add: point not on curve")
    return _pt_from(out.raw)


def g1_mul(p, k: int):
    lib = _load()
    out = ctypes.create_string_buffer(64)
    rc = lib.ez_g1_mul(_pt_bytes(p), int(k).to_bytes(32, "little"), out)
    if rc != 0:
        raise ValueError("g1_mul: point not on curve")
    return _pt_from(out.raw)


def g1_msm(points, scalars):
    lib = _load()
    n = len(points)
    pbuf = b"".join(_pt_bytes(p) for p in points)
    sbuf = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    out = ctypes.create_string_buffer(64)
    rc = lib.ez_g1_msm(pbuf, sbuf, n, out)
    if rc != 0:
        raise ValueError("g1_msm: point not on curve")
    return _pt_from(out.raw)


def pairing_check(pairs) -> bool:
    """pairs: [(g1_pt | None, g2_pt | None)]; g2 = ((x0,x1),(y0,y1))."""
    lib = _load()
    g1b, g2b = b"", b""
    for p, q in pairs:
        g1b += _pt_bytes(p)
        if q is None or p is None:
            g2b += b"\x00" * 128
            g1b = g1b[:-64] + b"\x00" * 64  # both zero -> skipped factor
        else:
            (x0, x1), (y0, y1) = q
            g2b += (int(x0).to_bytes(32, "little")
                    + int(x1).to_bytes(32, "little")
                    + int(y0).to_bytes(32, "little")
                    + int(y1).to_bytes(32, "little"))
    rc = lib.ez_pairing_check(g1b, g2b, len(pairs))
    if rc < 0:
        raise ValueError("pairing_check: malformed input point")
    return rc == 1

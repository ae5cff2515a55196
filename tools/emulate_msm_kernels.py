#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, to rehearse `csrc/msm.cu` without a card.

    python3 tools/emulate_msm_kernels.py

Compiles `ezkl_tpu_torch/csrc/*.cu` with g++ against `tools/cuda_emu/`, a
stand-in for the few CUDA pieces the kernels use (one std::thread per CUDA
thread, the blocks one after another, `__syncwarp` a barrier of the block),
with each `kernel<<<grid, block, smem, stream>>>(args)` rewritten into a call
of its emulated launch; the PTX carry helpers of `bn254.cuh` take their C
branch. Then holds K4 (at each team size, with pad pairs and a ragged last
block), K5 (both variants) and K8 (edge shapes, identities only) on CPU
tensors at tiny shapes against their plain versions, bit-exact. It checks
the kernels' logic (indices, teams, barriers, carries) and times nothing;
what only the card can show -- that nvcc accepts the source, the PTX, the
speed -- still needs `chip_smoke.py` there. Exits non-zero on a mismatch.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ezkl_tpu_torch.fieldmath import curve, limbs  # noqa: E402
from ezkl_tpu_torch.fieldmath.spec import bn254_fq  # noqa: E402
from ezkl_tpu_torch.kernels import build, pcurve  # noqa: E402

OUT = ROOT / "build" / "emu"


def _split_top(s: str) -> list:
    """Split at the commas outside parentheses and brackets."""
    parts, depth, cur = [], 0, ""
    for ch in s:
        depth += (ch in "([") - (ch in ")]")
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return [p.strip() for p in parts + [cur]]


def rewrite_launches(src: str) -> str:
    """`k<<<grid, block, smem, stream>>>(args);` -> `emu_launch(grid, block,
    [&] { k(args); });`"""
    out, i = "", 0
    while (k := src.find("<<<", i)) >= 0:
        j, depth = k, 0
        while j > 0:                                  # back over `name<T>`
            ch = src[j - 1]
            if ch in "<>":
                depth += 1 if ch == ">" else -1
            elif depth == 0 and not (ch.isalnum() or ch in "_:"):
                break
            j -= 1
        e = src.index(">>>", k)
        grid, block = _split_top(src[k + 3:e])[:2]
        q, d = e + 3, 0
        while True:                                   # the argument list's ")"
            d += (src[q] == "(") - (src[q] == ")")
            if d == 0:
                break
            q += 1
        out += src[i:j] + f"emu_launch({grid}, {block}, [&] {{ {src[j:k]}({src[e + 4:q]}); }})"
        i = q + 1
    return out + src[i:]


def build_library() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    sources = []
    for cu in sorted(build.CSRC.glob("*.cu")):
        cpp = OUT / (cu.stem + ".cpp")
        cpp.write_text(rewrite_launches(cu.read_text()))
        sources.append(str(cpp))
    lib = OUT / "libemu.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    f"-I{ROOT / 'tools' / 'cuda_emu'}", f"-I{build.CSRC}", "-o", str(lib),
                    *sources], check=True)
    handle = ctypes.CDLL(str(lib))
    for name, argtypes in build._SIGNATURES.items():
        getattr(handle, name).argtypes = argtypes
        getattr(handle, name).restype = ctypes.c_int
    return handle


def main() -> int:
    torch.set_num_threads(4)
    lib = build_library()

    def call(fn, ins, out_batch, post, pre=()):
        outs = [torch.empty((8,) + tuple(out_batch), dtype=torch.int32) for _ in range(3)]
        rc = getattr(lib, fn)(*pre, *[None if t is None else t.data_ptr() for t in ins],
                              *(o.data_ptr() for o in outs), *post, None)
        if rc:
            raise RuntimeError(f"{fn} returned {rc}")
        return outs

    dev, rng = torch.device("cpu"), np.random.default_rng(5)
    P, (ax, ay) = cs._pool(dev, rng, n=64)
    zero = torch.zeros(8, dtype=torch.int32)
    ident = (zero, limbs.const(bn254_fq(), 1, device=dev), zero)
    idx = lambda *shape: cs.torch_index(rng.integers(0, 64, size=shape), dev)  # noqa: E731
    failed = []

    def check(name, got, want):
        err = cs.max_abs_err(got, list(want))
        print(name, "max_abs_err", err, flush=True)
        if err:
            failed.append(name)

    for team in pcurve.SCAN_TEAMS:
        for S, L in ((6, 37), (5, 3), (3, 70)):
            x, y = cs._gather((ax, ay), idx(S, L))
            pad = torch.zeros(S, L, dtype=torch.bool)
            pad[0, 0] = pad[min(2, S - 1), 1] = True
            pad[:, 2] = True
            x, y = cs._set((x, y), pad, ident[:2])
            sn = cs.torch_index(rng.integers(0, 2, size=(S, L)), dev).to(torch.int32)
            check(f"scan_packed team={team} S={S} lanes={L}",
                  call("ez_scan_packed", [x, y, sn], (S, L), (L, S, team)),
                  pcurve.scan_packed_plain(x, y, sn))
    S, L = 4, 5
    Pq, Pa = cs._gather(P, idx(S, L)), cs._gather((ax, ay), idx(S, L))
    check("scan_steps complete", call("ez_scan_steps", list(Pq), (S, L), (L, S), pre=(0,)),
          pcurve.scan_steps_plain(curve.PointP(*Pq)))
    check("scan_steps mixed", call("ez_scan_steps", list(Pa) + [None], (S, L), (L, S), pre=(1,)),
          pcurve.scan_steps_plain(Pa))
    for W, c, C, everyone in ((4, 3, 3, False), (1, 1, 1, False), (3, 2, 2, True)):
        mask = torch.full((W, C), everyone)
        mask[0, 0] = True
        V = cs._set(cs._gather(P, idx(W, C)), mask, ident)
        check(f"horner W={W} c={c} width={C}{' identities' if everyone else ''}",
              call("ez_horner", list(V), (C,), (W, c, C)),
              pcurve.horner_plain(curve.PointP(*V), c))
    print("FAILED: " + ", ".join(failed) if failed else "all bit-exact")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

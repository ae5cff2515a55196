#!/usr/bin/env python3
"""The fused MSM's kernels K4-K8 alone on the card, and what they compile to.

    python3 tools/bench_msm_kernels.py [--sass]

Builds the kernels (printing ptxas' registers and spills), then runs
`chip_smoke.check_msm_kernels`: K4-K8 against their plain versions at the
k = 14 main path's shapes, bit-exact, with K4 and K5 at every team size, one
JSON `kernel` line each with device times and bounds. With `--sass`, prints for
each kernel of `msm.cu` its SASS instruction count by opcode (cuobjdump), so
the instruction mix of a design can be read beside its time. Needs one CUDA
card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402


def sass_histogram(obj: pathlib.Path) -> dict:
    """{kernel: {opcode: count}} of an object file's SASS."""
    from ezkl_tpu_torch.kernels import build
    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(obj)], capture_output=True, text=True,
                         check=True).stdout
    hist, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            hist[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            hist[name][m.group(1)] += 1
    return {k: dict(v.most_common()) for k, v in hist.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", action="store_true", help="print the SASS opcode counts")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_msm_kernels: no CUDA device", file=sys.stderr)
        return 2
    from ezkl_tpu_torch.kernels import build
    print(chip_smoke.nvidia_smi(), flush=True)
    build.build(verbose=True)
    build.lib()
    if args.sass:
        for kernel, ops in sass_histogram(build.BUILD_DIR / "msm.o").items():
            chip_smoke.emit({"sass": kernel, "instructions": sum(ops.values()), "opcodes": ops})
    chip_smoke.check_msm_kernels(torch.device("cuda", 0), np.random.default_rng(chip_smoke.SEED))
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The port's point and NTT kernels alone on the card, and what they compile to.

    python3 tools/bench_msm_kernels.py [--only msm ntt adds k1 dbl] [--sass]

Builds the kernels (printing ptxas' registers and spills), then runs the
checks of `chip_smoke.py` named by `--only` (default `msm`): `msm`,
`check_msm_kernels` (K4-K8 at the k = 14 main path's shapes, K4-K6 at
every team size); `ntt`, `check_ntt_stages` (K2: every pass of k = 1 .. 17,
each whole transform of the prove and a sweep of its groups per block);
`adds`, `check_point_adds` (K3's tree and its single add at every team
size and width the prove launches); `k1`, `check_mont_mul` (K1
elementwise in every broadcast form); `dbl`, `check_point_dbl` (K9 at every
team size). Each is bit-exact against its plain
version, one JSON `kernel` line per case with device times and bounds. With
`--sass`, prints for each kernel of `msm.cu`, `field.cu` and `curve.cu` its
SASS instruction count by opcode (cuobjdump), so the instruction mix of a
design can be read beside its time. Needs one CUDA card; prints the card's
name and power limit first.
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
    ap.add_argument("--only", nargs="+", choices=("msm", "ntt", "adds", "k1", "dbl"),
                    default=["msm"],
                    help="which kernels to check and time")
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
        for obj in ("msm.o", "field.o", "curve.o"):
            for kernel, ops in sass_histogram(build.BUILD_DIR / obj).items():
                chip_smoke.emit({"sass": kernel, "instructions": sum(ops.values()),
                                 "opcodes": ops})
    checks = {"msm": chip_smoke.check_msm_kernels, "ntt": chip_smoke.check_ntt_stages,
              "adds": chip_smoke.check_point_adds, "k1": chip_smoke.check_mont_mul,
              "dbl": chip_smoke.check_point_dbl}
    dev, rng = torch.device("cuda", 0), np.random.default_rng(chip_smoke.SEED)
    for name in args.only:
        checks[name](dev, rng)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

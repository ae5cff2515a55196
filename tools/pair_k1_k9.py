#!/usr/bin/env python3
"""K1 elementwise and K9 of several checkouts of the port, timed in turn on one card.

    python3 tools/pair_k1_k9.py TREE [TREE ...]    # e.g. parent change change parent

Runs each TREE (a checkout of this repo, e.g. a `git archive` of an older
commit unpacked under `_archive/`) in a fresh Python process, in the order
given, with the port imported from that tree and its kernels built in the
tree's own `build/`. Each process, on the same seeded inputs: K1
(`limbs._mont_mul_kernel`) in Fr, dense at 2^14 and 2^17 elements and with a
constant b at 2^17; K9 (`pcurve.point_dbl`) at `chip_smoke.DBL_LANES`. Each
case is held bit-exact against the tree's plain version and timed as
`chip_smoke.py` times a kernel (`ms` from HBM, `l2_ms`, `bound_ms`), one
JSON `pair` line per case with the tree and its place in the order. The
helpers are this checkout's `chip_smoke.py`, which imports the port only
inside its functions. Needs one CUDA card; exits non-zero on a mismatch.
"""

from __future__ import annotations

import importlib.util
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def child(tree: str, run: int) -> int:
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location("smoke_helpers", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    from ezkl_tpu_torch.fieldmath import curve, limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr
    from ezkl_tpu_torch.kernels import pcurve

    dev, rng = torch.device("cuda", 0), np.random.default_rng(cs.SEED)
    fr, mm = bn254_fr(), cs.IMAD_PER_MONT_MUL

    def case(kernel, kern, plain, inputs, nbytes, imad, **shape):
        err = cs.max_abs_err(cs._outputs(kern(*inputs)), cs._outputs(plain(*inputs)))
        row = dict(tree=tree, run=run, kernel=kernel, **shape, max_abs_err=err,
                   ms=cs.device_ms(kern, inputs), l2_ms=cs.device_ms(kern, inputs, cold=False))
        row["bound_ms"], row["bound_by"] = cs.bound(nbytes, imad)
        cs.emit({"phase": "pair", **row})
        return err

    errs = 0
    mul = lambda x, y: limbs._mont_mul_kernel(fr, x, y)          # noqa: E731
    mul_plain = lambda x, y: limbs.mont_mul_plain(fr, x, y)      # noqa: E731
    for n in (1 << 14, 1 << 17):
        a, b = cs.field_inputs(fr, n, rng, dev)
        errs += case("mont_mul", mul, mul_plain, [a, b.contiguous()], 96 * n, mm * n, n=n,
                     b="dense")
        if n == 1 << 17:
            c = limbs.bcast_const(fr, 12345, 1, device=dev)
            errs += case("mont_mul", mul, mul_plain, [a, c], 64 * n + 32, mm * n, n=n,
                         b="constant")
    P, _ = cs._pool(dev, rng)
    dbl = lambda *t: pcurve.point_dbl(curve.PointP(*t))          # noqa: E731
    dbl_plain = lambda *t: pcurve.point_dbl_plain(curve.PointP(*t))   # noqa: E731
    for n in cs.DBL_LANES:
        errs += case("point_dbl", dbl, dbl_plain, cs.dbl_inputs(P, n, dev, rng), 192 * n,
                     8 * mm * n, lanes=n)
    return 1 if errs else 0


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2], int(sys.argv[3]))
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for run, tree in enumerate(sys.argv[1:]):
        rc = subprocess.run([sys.executable, __file__, "--child", tree, str(run)]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())

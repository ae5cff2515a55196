#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, to rehearse `csrc/*.cu` without a card.

    python3 tools/emulate_msm_kernels.py [--prove]

Compiles `ezkl_tpu_torch/csrc/*.cu` with g++ against `tools/cuda_emu/`, a
stand-in for the few CUDA pieces the kernels use (one std::thread per CUDA
thread, the blocks one after another, `__syncthreads` a barrier of the block,
`__syncwarp(mask)` one of the threads of the warp that `mask` names),
with each `kernel<<<grid, block, smem, stream>>>(args)` rewritten into a call
of its emulated launch; the PTX carry helpers of `bn254.cuh` take their C
branch. Then holds K1 (`ez_mont_mul` through its wrapper in both fields, in
every broadcast form, either operand side, over ragged last blocks and
n = 1) and its chain forms
(`ez_mont_pow` in both fields with zeros in the batch, `ez_mont_scan` over
one and several rows), K2 (`ez_ntt_stages`: every pass (s0, r) of every
k <= 12, forward and inverse, over two columns, each at a seeded choice of
groups per block), K3 (the single add at each team size over a ragged lane
count, and the tree `ez_point_reduce` at w = 128 over 3 groups and at
w = 2, with identity lanes), K9 (`ez_point_dbl` at each team size,
identity lanes first and last, ragged last blocks), K4 (at each team size,
with pad pairs and a ragged last block), K5 (both variants at each team
size, with identities and a ragged last block), K6 (both variants at each
team size, identities, a ragged last block, one chunk), K7 (c = 1 to 3,
identities, ragged lanes) and K8 (edge shapes, identities only) on CPU
tensors at tiny shapes against their plain versions, bit-exact. It checks
the kernels' logic (indices, teams, barriers, carries) and times nothing;
what only the card can show -- that nvcc accepts the source, the PTX, the
speed -- still needs `chip_smoke.py` there. With `--prove` it then keys and
proves both K=4 circuits of `tests/torch_port_circuits.py` with every kernel
wrapper taking its card route into the emulated library (CPU tensors pass
for card tensors), and compares each proof with the JAX package's frozen in
`tests/fixtures/torch_port/` (~80 s). Exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ezkl_tpu_torch.fieldmath import curve, limbs  # noqa: E402
from ezkl_tpu_torch.fieldmath.spec import bn254_fq, bn254_fr  # noqa: E402
from ezkl_tpu_torch.kernels import build, ntt, pcurve, pntt  # noqa: E402

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


@contextlib.contextmanager
def card_route(lib):
    """Every kernel wrapper takes its card route into `lib`: CPU tensors pass
    for card tensors."""
    saved = build._LIB, build.stream_of
    build._LIB, build.stream_of = lib, (lambda t: None)
    torch.Tensor.is_cuda = property(lambda self: True)
    try:
        yield
    finally:
        del torch.Tensor.is_cuda
        build._LIB, build.stream_of = saved


def mont_mul_cases(lib, rng, report):
    """`ez_mont_mul` through its wrapper in both fields, in every broadcast
    form, either operand side: dense at n = 1, 151 and 1,100 (a ragged last
    block), a constant, a row of 20 and of 5, one value per row of 20 and of
    5, a run of middle dims and both operands broadcast."""
    dev = torch.device("cpu")
    for spec in (bn254_fr(), bn254_fq()):
        def elems(*shape):
            n = int(np.prod(shape))
            vals = [int.from_bytes(rng.bytes(32), "little") % spec.modulus for _ in range(n)]
            vals[0] = 0
            return limbs.to_device(limbs.encode(spec, vals), dev).reshape((8,) + shape)

        x = elems(3, 20)
        cases = {f"dense n={n}": (elems(n), elems(n)) for n in (1, 151, 1100)}
        cases.update({
            "constant": (x, elems(1, 1)), "row of 20": (x, elems(1, 20)),
            "row of 5": (elems(6, 5), elems(1, 5)), "per row of 20": (x, elems(3, 1)),
            "per row of 5": (elems(6, 5), elems(6, 1)),
            "middle dims": (elems(2, 3, 4), elems(1, 3, 1)),
            "both broadcast": (x[:, :1, :], x[:, :, :1])})
        errs = {}
        with card_route(lib):
            for name, (a, b) in cases.items():
                want = limbs.mont_mul_plain(spec, a, b)
                errs[name] = max(cs.max_abs_err([limbs._mont_mul_kernel(spec, lhs, rhs)], [want])
                                 for lhs, rhs in ((a, b), (b, a)))
        for name, err in errs.items():
            report(f"mont_mul {spec.name} {name}", err)


def prove_through_the_kernel_routes(lib) -> list:
    """Both K=4 circuits proved with every wrapper on its kernel route into
    `lib`; returns the names of the circuits whose proof is not byte-equal to
    the frozen reference or does not verify."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_port_circuits as circuits
    from ezkl_tpu_torch.plonk import cs as csmod, keygen, prover, srs as srsmod, verifier
    from ezkl_tpu_torch.plonk.assign import Assignment

    with card_route(lib):
        srs = srsmod.gen_srs(circuits.K, device="cpu")
        failed = []
        for name in sorted(circuits.CIRCUITS):
            fx = json.loads((ROOT / "tests" / "fixtures" / "torch_port" / f"{name}.json")
                            .read_text())
            make, fill = circuits.CIRCUITS[name]
            system, cols = make(csmod)
            asg = fill(system, cols, Assignment)
            pk = keygen.keygen(system, circuits.K, srs, asg, device="cpu")
            build.reset_launches()
            proof = prover.create_proof(pk, srs, asg, seed=fx["seed"])
            same = proof.to_json() == fx["proof"]
            ok = verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
            print(f"prove {name}: byte-equal {same}, verifies {ok}, launches",
                  json.dumps(build.LAUNCHES), flush=True)
            if not (same and ok):
                failed.append(f"prove {name}")
        return failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prove", action="store_true",
                    help="also prove the K=4 circuits through the emulated kernels")
    args = ap.parse_args()
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

    def report(name, err):
        print(name, "max_abs_err", err, flush=True)
        if err:
            failed.append(name)

    def check(name, got, want):
        report(name, cs.max_abs_err(got, list(want)))

    fr = bn254_fr()
    for k in range(1, 13):
        errs = 0
        for inverse in (False, True):
            tw = ntt.twiddles(fr, k, inverse, dev)
            x = limbs.to_device(limbs.encode(fr, [
                int.from_bytes(rng.bytes(32), "little") % fr.modulus for _ in range(2 << k)]),
                dev).reshape(8, 2, 1 << k)
            for s0 in range(k):
                want = x
                for r in range(1, min(pntt.MAX_STAGES, k - s0) + 1):
                    want = pntt.bfly_plain(fr, want, pntt.stage_twiddles(tw, k, s0 + r))
                    cap = pntt.max_log_groups(k, s0, r)
                    out = torch.empty_like(x)
                    rc = lib.ez_ntt_stages(0, x.data_ptr(), tw.data_ptr(), out.data_ptr(), 2, k,
                                           s0, r, int(rng.integers(0, cap + 1)), None)
                    if rc:
                        raise RuntimeError(f"ez_ntt_stages returned {rc}")
                    errs = max(errs, cs.max_abs_err([out], [want]))
        name = f"ntt_stages k={k} every (s0, r), forward and inverse, 2 columns"
        print(name, "max_abs_err", errs, flush=True)
        if errs:
            failed.append(name)
    mask = torch.zeros(37, dtype=torch.bool)
    mask[0] = mask[5] = True
    A = cs._set(cs._gather(P, idx(37)), mask, ident)
    mask[0], mask[6] = False, True
    B = cs._set(cs._gather(P, idx(37)), mask, ident)
    for team in pcurve.ADD_TEAMS:
        check(f"point_add team={team} lanes=37",
              call("ez_point_add", [*A, *B], (37,), (37, team)),
              pcurve.point_add_plain(curve.PointP(*A), curve.PointP(*B)))
    for G, w in ((3, 128), (5, 2)):
        mask = torch.zeros(G, w, dtype=torch.bool)
        mask[0, 0] = mask[G - 1, w - 1] = True
        mask[1] = True
        Q = cs._set(cs._gather(P, idx(G, w)), mask, ident)
        check(f"point_reduce groups={G} w={w}", call("ez_point_reduce", list(Q), (G,), (G, w)),
              pcurve.reduce_pairwise_plain(curve.PointP(*Q)))
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
    for team in pcurve.SCAN_TEAMS:
        for S, L in ((4, 5), (3, 70)):
            mask = torch.zeros(S, L, dtype=torch.bool)
            mask[0, 0] = mask[min(2, S - 1), 1] = True
            Pq = cs._set(cs._gather(P, idx(S, L)), mask, ident)
            Pa = cs._gather((ax, ay), idx(S, L))
            check(f"scan_steps complete team={team} S={S} lanes={L}",
                  call("ez_scan_steps", list(Pq), (S, L), (L, S, team), pre=(0,)),
                  pcurve.scan_steps_plain(curve.PointP(*Pq)))
            check(f"scan_steps mixed team={team} S={S} lanes={L}",
                  call("ez_scan_steps", list(Pa) + [None], (S, L), (L, S, team), pre=(1,)),
                  pcurve.scan_steps_plain(Pa))
    for team in pcurve.SCAN_TEAMS:
        for G, chunks, blk in ((3, 3, 37), (2, 1, 5), (1, 4, 70)):
            mask = torch.zeros(G, chunks * blk, dtype=torch.bool)
            mask[0, 0] = mask[G - 1, chunks * blk - 1] = True
            mask[0, blk:2 * blk] = True
            Pq = cs._set(cs._gather(P, idx(G, chunks * blk)), mask, ident)
            Pa = cs._gather((ax, ay), idx(G, chunks * blk))
            post = (G, chunks, blk, team)
            check(f"fold_lanes complete team={team} groups={G} chunks={chunks} blk={blk}",
                  call("ez_fold_lanes", list(Pq), (G, blk), post, pre=(0,)),
                  pcurve.fold_lanes_plain(curve.PointP(*Pq), blk))
            check(f"fold_lanes mixed team={team} groups={G} chunks={chunks} blk={blk}",
                  call("ez_fold_lanes", list(Pa) + [None], (G, blk), post, pre=(1,)),
                  pcurve.fold_lanes_plain(Pa, blk))
    for team in pcurve.DBL_TEAMS:
        for n in (37, 70, 3):
            mask = torch.zeros(n, dtype=torch.bool)
            mask[0] = mask[n - 1] = True
            Q = cs._set(cs._gather(P, idx(n)), mask, ident)
            check(f"point_dbl team={team} lanes={n}",
                  call("ez_point_dbl", list(Q), (n,), (n, team)),
                  pcurve.point_dbl_plain(curve.PointP(*Q)))
    for n, c in ((37, 3), (70, 1), (3, 2)):
        mask = torch.zeros(n, dtype=torch.bool)
        mask[0] = mask[n - 1] = True
        Q = cs._set(cs._gather(P, idx(n)), mask, ident)
        check(f"dbl_pow2 lanes={n} c={c}", call("ez_dbl_pow2", list(Q), (n,), (n, c)),
              pcurve.dbl_pow2_plain(curve.PointP(*Q), c))
    for W, c, C, everyone in ((4, 3, 3, False), (1, 1, 1, False), (3, 2, 2, True)):
        mask = torch.full((W, C), everyone)
        mask[0, 0] = True
        V = cs._set(cs._gather(P, idx(W, C)), mask, ident)
        check(f"horner W={W} c={c} width={C}{' identities' if everyone else ''}",
              call("ez_horner", list(V), (C,), (W, c, C)),
              pcurve.horner_plain(curve.PointP(*V), c))
    for spec in (bn254_fr(), bn254_fq()):
        p = spec.modulus
        vals = [0, 1, p - 1] + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(34)]
        vals[20] = 0
        a = limbs.to_device(limbs.encode(spec, vals), dev)
        for e in (1, 2, 3, 0x10001, p - 2, (1 << 255) + 1, (1 << 256) - 1):
            out = torch.empty_like(a)
            first, windows, trailing, _ = limbs.pow_schedule(e)
            sq = (ctypes.c_uint8 * 64)(*(w[0] for w in windows))
            dig = (ctypes.c_uint8 * 64)(*(w[1] for w in windows))
            rc = lib.ez_mont_pow(limbs._FIELD_ID[spec.name], a.data_ptr(), out.data_ptr(),
                                 a.shape[1], ctypes.addressof(sq), ctypes.addressof(dig),
                                 len(windows), first, trailing, None)
            if rc:
                raise RuntimeError(f"ez_mont_pow returned {rc}")
            check(f"mont_pow {spec.name} e={'p-2' if e == p - 2 else hex(e)} n=37",
                  [out], [limbs.pow_static_plain(spec, a, e)])
        for rows, steps in ((1, 32), (3, 17), (5, 1), (40, 33)):
            v = limbs.to_device(limbs.encode(spec, [
                int.from_bytes(rng.bytes(32), "little") % p for _ in range(rows * steps)]),
                dev).reshape(8, rows, steps)
            out = torch.empty_like(v)
            rc = lib.ez_mont_scan(limbs._FIELD_ID[spec.name], v.data_ptr(), out.data_ptr(),
                                  rows, steps, None)
            if rc:
                raise RuntimeError(f"ez_mont_scan returned {rc}")
            check(f"mont_scan {spec.name} rows={rows} steps={steps}",
                  [out], [limbs.seq_scan_mul_plain(spec, v)])
    mont_mul_cases(lib, rng, report)
    if args.prove:
        failed += prove_through_the_kernel_routes(lib)
    print("FAILED: " + ", ".join(failed) if failed else "all bit-exact")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

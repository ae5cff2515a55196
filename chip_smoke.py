#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`ezkl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  -- the card (nvidia-smi name and power limit), CUDA and nvcc versions
2. build   -- nvcc builds `ezkl_tpu_torch/csrc/*.cu` for sm_90a
3. kernels -- every kernel of the proving path (K1 Montgomery multiply, K2
              NTT butterfly, K3 point add, K9 point doubling) against its
              plain PyTorch version on the card, bit-exact, on seeded inputs
              plus edge values, at the main path's shapes (K1 also with its
              broadcast operand forms); timed as device time per launch
              (`ms`: launches replayed from a CUDA graph, cycling over
              copies of the inputs that overflow the L2, so operands come
              from HBM as `bound_ms` assumes; `l2_ms`: the same launch
              repeated on one set of inputs, which then sits in L2), as
              eager calls from Python (`eager_ms`) and, for the plain
              version, eagerly (`plain_ms`)
4. prove   -- the main path at k = 14: gen_srs, keygen, create_proof(seed=1)
              of a circuit with a multiplication gate, a 256-entry lookup,
              copy constraints into the instance and a shuffle, filled over
              every usable row; verified by the port's host verifier, which
              must reject the proof with a tampered instance. Launch counts
              of every kernel are reset just before create_proof and read
              just after; each must be > 0.
5. check   -- a 2^14-point MSM on the card against the host MSM, and an NTT
              round trip at 2^17

Then the `kernels` summary line (times, bounds, launches), the nvidia-smi
line, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

SEED = 1
K = 14
REPS = 20
GRAPH_REPS = 100

# H100 SXM peaks (NVIDIA data sheet; 700 W): HBM bytes/s, and 32-bit integer
# multiply-adds/s = 132 SMs x 64 IMAD per clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
IMAD_PER_S = 132 * 64 * 1.98e9
# a 256-bit Montgomery multiply (8x8-word CIOS): 128 32x32->64 products at
# two IMADs each + 8 low products
IMAD_PER_MONT_MUL = 2 * 128 + 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def _events():
    import torch
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def time_ms(fn, reps=REPS):
    """Time per call of `fn` issued eagerly from Python in a loop (what the
    prover's sequential steps see), CUDA events around the loop."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = _events()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(kernel, inputs, cold=True, reps=GRAPH_REPS):
    """Device time of one launch of `kernel(*inputs)`: `reps` launches
    captured in one CUDA graph and replayed between CUDA events, so that the
    host's launch overhead is not in the number. Every output is kept, so
    each launch writes fresh memory. With `cold`, the launches cycle over
    enough copies of the inputs to pass twice the L2, so each launch reads
    its operands from HBM; else they all read the one set, from L2 where it
    fits."""
    import torch
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = min(reps, -(-2 * L2_BYTES // nbytes)) if cold else 1
    sets = [inputs] + [[t.clone() for t in inputs] for _ in range(copies - 1)]
    kernel(*inputs)
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(reps):
            outs.append(kernel(*sets[i % copies]))
    graph.replay()
    torch.cuda.synchronize()
    start, end = _events()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph, outs, sets
    return start.elapsed_time(end) / reps


def timings(kernel, inputs, plain):
    """`ms` (operands from HBM), `l2_ms`, `eager_ms` and `plain_ms`."""
    return dict(ms=device_ms(kernel, inputs), l2_ms=device_ms(kernel, inputs, cold=False),
                eager_ms=time_ms(lambda: kernel(*inputs)),
                plain_ms=time_ms(lambda: plain(*inputs), 3))


def bound(nbytes, imad):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, imad / IMAD_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b) -> int:
    """Largest difference between the u32 limbs of two results (0 = bit-exact)."""
    import torch
    da = torch.cat([t.reshape(-1) for t in a]).long() & 0xFFFFFFFF
    db = torch.cat([t.reshape(-1) for t in b]).long() & 0xFFFFFFFF
    return int((da - db).abs().max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def field_inputs(spec, n, rng, dev):
    from ezkl_tpu_torch.fieldmath import limbs
    p = spec.modulus
    edge = [0, 1, p - 1, spec.r % p]
    vals = edge + [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n - len(edge))]
    a = limbs.to_device(limbs.encode(spec, vals, mont=False), dev)
    perm = rng.permutation(n)
    perm[:16] = np.arange(16)[::-1] % 4          # edge x edge in the first lanes
    return a, a[:, torch_index(perm, dev)]


def torch_index(arr, dev):
    import torch
    return torch.from_numpy(np.asarray(arr, np.int64)).to(dev)


def check_kernels(dev, rng):
    import torch
    from ezkl_tpu_torch.fieldmath import limbs, curve
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr, bn254_fq
    from ezkl_tpu_torch.kernels import pntt, pcurve, build

    FR, FQ = bn254_fr(), bn254_fq()
    rows = {}

    # K1 at both main-path widths, both fields
    for spec in (FR, FQ):
        for n in (1 << 14, 1 << 17):
            a, b = field_inputs(spec, n, rng, dev)
            b = b.contiguous()
            kern = lambda x, y: limbs._mont_mul_kernel(spec, x, y)   # noqa: E731
            plain = lambda x, y: limbs.mont_mul_plain(spec, x, y)    # noqa: E731
            err = max_abs_err([kern(a, b)], [plain(a, b)])
            row = dict(field=spec.name, n=n, max_abs_err=err, **timings(kern, [a, b], plain))
            row["bound_ms"], row["bound_by"] = bound(3 * 32 * n, IMAD_PER_MONT_MUL * n)
            emit({"phase": "kernel", "kernel": "mont_mul", **row})
            if err:
                raise AssertionError(f"mont_mul kernel != plain ({spec.name}, n={n})")
            if spec is FR and n == 1 << 17:
                rows["mont_mul"] = row

    # K1's broadcast operand (read in place, `limbs.bcast_form`) in the forms
    # the prover gives it, either operand side, against the plain version
    n = 1 << 14
    x = field_inputs(FR, 8 * n, rng, dev)[0].reshape(8, 8, n)
    forms = {"constant": limbs.bcast_const(FR, 12345, 2, device=dev),
             "row": field_inputs(FR, n, rng, dev)[0].reshape(8, 1, n),
             "column": x[:, :, :1],
             "expanded": limbs.ones_mont(FR, (8, n), dev),
             "both": (x[:, :1, :], x[:, :, :1])}
    for form, b in forms.items():
        lhs, rhs = b if form == "both" else (x, b)
        want = limbs.mont_mul_plain(FR, lhs, rhs)
        err = max(max_abs_err([limbs.mont_mul(FR, lhs, rhs)], [want]),
                  max_abs_err([limbs.mont_mul(FR, rhs, lhs)], [want]))
        if err:
            raise AssertionError(f"mont_mul kernel != plain (broadcast {form})")
    n = 1 << 17
    a = field_inputs(FR, n, rng, dev)[0]
    c = limbs.bcast_const(FR, 12345, 1, device=dev)
    emit({"phase": "kernel", "kernel": "mont_mul", "field": FR.name, "n": n,
          "b": "constant", "broadcast_forms_checked": sorted(forms), "max_abs_err": 0,
          "ms": device_ms(lambda x, y: limbs.mont_mul(FR, x, y), [a, c]),
          "materialised_b_ms": device_ms(lambda x, y: limbs.mont_mul(FR, x, y),
                                         [a, c.expand(8, n).contiguous()]),
          "bound_ms": bound(2 * 32 * n, IMAD_PER_MONT_MUL * n)[0]})

    # K2: every stage shape of a 2^17 NTT (extended domain); time the last
    n = 1 << 17
    x, _ = field_inputs(FR, n, rng, dev)
    tw = limbs.to_device(limbs.encode(FR, [int.from_bytes(rng.bytes(32), "little")
                                           for _ in range(n // 2)]), dev)
    for log_half in range(17):
        w = tw[:, : 1 << log_half].contiguous()
        err = max_abs_err([pntt._bfly_kernel(FR, x, w)], [pntt.bfly_plain(FR, x, w)])
        if err:
            raise AssertionError(f"bfly kernel != plain (half=2^{log_half})")
    kern = lambda y, t: pntt._bfly_kernel(FR, y, t)                  # noqa: E731
    row = dict(field=FR.name, n=n, half=n // 2, max_abs_err=0,
               **timings(kern, [x, w], lambda y, t: pntt.bfly_plain(FR, y, t)))
    row["bound_ms"], row["bound_by"] = bound(2 * 32 * n + 32 * (n // 2),
                                             IMAD_PER_MONT_MUL * (n // 2))
    emit({"phase": "kernel", "kernel": "bfly", "stages_checked": 17, **row})
    rows["bfly"] = row

    # K3 / K9 on projective multiples of G1 with nontrivial Z, plus edges
    for n in (1 << 14, 1 << 17):
        bits = torch_index(rng.integers(0, 2, size=(64, n)), dev).to(torch.int32)
        P = curve.scalar_mul(curve.generator((n,), dev), bits)
        Q = P.map(lambda t: t.roll(1, dims=-1).contiguous())
        ident = curve.identity((n,), dev)
        negP = curve.neg(P)
        lanes = torch.arange(n, device=dev)
        # lane 0: P + O, lane 1: P + P, lane 2: P + (-P), lane 3: O + O
        Q = curve.select_point(lanes == 0, ident, Q)
        Q = curve.select_point(lanes == 1, P, Q)
        Q = curve.select_point(lanes == 2, negP, Q)
        P2 = curve.select_point(lanes == 3, ident, P)
        Q = curve.select_point(lanes == 3, ident, Q)
        P2, Q = P2.map(torch.Tensor.contiguous), Q.map(torch.Tensor.contiguous)
        for name, inputs, kern, plain, muls in (
                ("point_add", [*P2, *Q],
                 lambda *t: pcurve._launch("point_add", "ez_point_add", t),
                 lambda *t: pcurve.point_add_plain(curve.PointP(*t[:3]), curve.PointP(*t[3:])),
                 12),
                ("point_dbl", list(P2),
                 lambda *t: pcurve._launch("point_dbl", "ez_point_dbl", t),
                 lambda *t: pcurve.point_dbl_plain(curve.PointP(*t)), 8)):
            nin = len(inputs)
            err = max_abs_err(kern(*inputs), plain(*inputs))
            row = dict(n=n, max_abs_err=err, **timings(kern, inputs, plain))
            row["bound_ms"], row["bound_by"] = bound((nin + 3) * 32 * n,
                                                     muls * IMAD_PER_MONT_MUL * n)
            emit({"phase": "kernel", "kernel": name, **row})
            if err:
                raise AssertionError(f"{name} kernel != plain (n={n})")
            if n == 1 << 14:
                rows[name] = row
        # the edge lanes against the group law itself
        s = curve.decode_points(pcurve.point_add(P2, Q).map(lambda t: t[:, :4]))
        p0 = curve.decode_points(P.map(lambda t: t[:, :2]))
        d = curve.decode_points(pcurve.point_dbl(P).map(lambda t: t[:, 1:2]))
        if not (s[0] == p0[0] and s[1] == d[0] and s[2] is None and s[3] is None):
            raise AssertionError("point_add edge lanes wrong")
    build.reset_launches()        # comparison launches do not count
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path at k = 14
# ---------------------------------------------------------------------------

def build_circuit(rng, k=K):
    """The k-row circuit of the prove phase and its seeded witness."""
    from ezkl_tpu_torch.plonk import cs as csmod
    from ezkl_tpu_torch.plonk.assign import Assignment
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr

    p = bn254_fr().modulus
    n = 1 << k
    use = csmod.last_active_row(n)        # usable rows [0, use)
    cs = csmod.ConstraintSystem()
    a, b, c = cs.advice_column(), cs.advice_column(), cs.advice_column()
    d, e = cs.advice_column(), cs.advice_column()
    q_mul, table, sel = cs.fixed_column(), cs.fixed_column(), cs.fixed_column()
    inst = cs.instance_column()
    va, vb, vc, vd, ve = (cs.query(x) for x in (a, b, c, d, e))
    vs = cs.query(sel)
    cs.create_gate("mul", cs.query(q_mul) * (va * vb - vc))
    cs.add_lookup("a_in_table", [(va,)], (cs.query(table),))
    cs.add_shuffle("e_perm_of_d", (vs * vd, vs), (vs * ve, vs))
    for col in (a, c, inst):
        cs.enable_equality(col)

    # c_i = a_i * b_i with c_i in [1, 256) copied into a_{i+1}: every a is in
    # the table; b_i = c_i / a_i is a full-width field element
    cvals = rng.integers(1, 256, size=use).astype(object)
    avals = np.concatenate([[int(rng.integers(1, 256))], cvals[:-1]]).astype(object)
    bvals = [int(cv) * pow(int(av), -1, p) % p for av, cv in zip(avals, cvals)]
    dvals = rng.integers(0, 1 << 62, size=use)
    asg = Assignment.empty(cs, k)
    asg.set_ints(a, 0, [int(v) for v in avals])
    asg.set_ints(b, 0, bvals)
    asg.set_ints(c, 0, [int(v) for v in cvals])
    asg.set_i64(d, 0, dvals)
    asg.set_i64(e, 0, rng.permutation(dvals))
    asg.set_i64(q_mul, 0, np.ones(use, np.int64))
    asg.set_i64(table, 0, np.arange(256, dtype=np.int64))
    asg.set_i64(sel, 0, np.ones(use, np.int64))
    asg.set_instance(inst, [int(cvals[-1])])
    rows = np.arange(use - 1, dtype=np.int64)
    asg.copies.append((c, rows, a, rows + 1))
    asg.copy(c, use - 1, inst, 0)
    return cs, asg, use


def prove(dev, rng):
    import torch
    from ezkl_tpu_torch.kernels import build
    from ezkl_tpu_torch.plonk import keygen, prover, srs as srsmod, verifier

    cs, asg, use = build_circuit(rng)
    t0 = time.perf_counter()
    srs = srsmod.gen_srs(K, device=dev)
    torch.cuda.synchronize()
    t_srs = time.perf_counter() - t0
    t0 = time.perf_counter()
    pk = keygen.keygen(cs, K, srs, asg, device=dev)
    torch.cuda.synchronize()
    t_keygen = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    proof = prover.create_proof(pk, srs, asg, seed=SEED)
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    t0 = time.perf_counter()
    ok = verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
    t_verify = time.perf_counter() - t0
    bad = dataclasses.replace(proof, instances=[[(proof.instances[0][0] + 1)]])
    rejected = not verifier.verify(pk.vk, srs.g2, srs.s_g2, bad)
    emit({"phase": "prove", "k": K, "extended_k": pk.vk.domain.extended_k,
          "rows_used": use,
          "srs_s": t_srs, "keygen_s": t_keygen, "prove_s": t_prove, "verify_s": t_verify,
          "prove_phases_s": dict(prover.PHASE_SECONDS),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "verified": ok, "tampered_rejected": rejected})
    if not ok:
        raise AssertionError("the port's verifier rejected the k=14 proof")
    if not rejected:
        raise AssertionError("the verifier accepted a proof with a tampered instance")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return srs, launches


# ---------------------------------------------------------------------------
# phase 5: outputs against references
# ---------------------------------------------------------------------------

def check_outputs(dev, rng, srs):
    import torch
    from ezkl_tpu_torch.fieldmath import limbs, curve, hostcurve, native
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr
    from ezkl_tpu_torch.kernels import msm, ntt

    FR = bn254_fr()
    n = 1 << K if native.available() else 256
    pts = srs.g1.map(lambda t: t[:, :n].contiguous())
    scal = [int.from_bytes(rng.bytes(32), "little") % FR.modulus for _ in range(n)]
    t0 = time.perf_counter()
    got = curve.decode_points(msm.msm(pts, limbs.to_device(
        limbs.encode(FR, scal, mont=False), dev)).map(lambda t: t[:, None]))[0]
    t_msm = time.perf_counter() - t0
    want = hostcurve.g1_msm(curve.decode_points(pts), scal)
    x, _ = field_inputs(FR, 1 << 17, rng, dev)
    round_trip = torch.equal(ntt.intt(FR, ntt.ntt(FR, x)), x)
    small = limbs.to_device(limbs.encode(FR, scal[:64]), dev)
    ntt_ok = list(limbs.decode(FR, ntt.ntt(FR, small))) == ntt.host_ntt(FR, scal[:64])
    emit({"phase": "check", "msm_n": n, "msm_matches_host": got == want, "msm_s": t_msm,
          "ntt_round_trip_2^17": round_trip, "ntt_64_matches_host": ntt_ok})
    if not (got == want and round_trip and ntt_ok):
        raise AssertionError("device outputs disagree with the host references")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ezkl_tpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing ({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    rng = np.random.default_rng(SEED)
    rows = check_kernels(dev, rng)
    srs, launches = prove(dev, rng)
    check_outputs(dev, rng, srs)

    meta = {
        "mont_mul": ("ezkl_tpu_torch/csrc/field.cu", "ezkl_tpu/fieldmath/limbs.py:682"),
        "bfly": ("ezkl_tpu_torch/csrc/field.cu", "ezkl_tpu/kernels/pntt.py:31"),
        "point_add": ("ezkl_tpu_torch/csrc/curve.cu", "ezkl_tpu/kernels/pcurve.py:199"),
        "point_dbl": ("ezkl_tpu_torch/csrc/curve.cu", "ezkl_tpu/kernels/pcurve.py:215"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "ok": rows[name]["max_abs_err"] == 0,
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "l2_ms": rows[name]["l2_ms"],
         "eager_ms": rows[name]["eager_ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
         "library_ms": None, "shape_n": rows[name]["n"]}
        for name, (src, rep) in meta.items()]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

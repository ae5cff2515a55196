#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`ezkl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  -- the card (nvidia-smi name and power limit), CUDA and nvcc versions
2. build   -- nvcc builds `ezkl_tpu_torch/csrc/*.cu` for sm_90a
3. kernels -- every kernel of the port (K1 Montgomery multiply, elementwise
              and in its chain forms mont_pow (a^(p-2) per element) and
              mont_scan (prefix product of rows of steps), K2 NTT
              butterfly stages (ntt_stages: every pass of k = 1 .. 17,
              forward and inverse, and a line per whole transform at the
              prove's 1 x 2^14, 8 x 2^14 and 16 x 2^17 with a sweep of its
              groups per block), K3 point add (at every team size and every
              width the prove launches it) and its tree form point_reduce
              (G = 26 and 208 groups of 128), K9 point doubling (at 1, 26,
              2^13, 2^14 and 2^17 lanes, each at every team size), and the fused
              MSM's K4 packed signed scan, K5 point prefix scan and K6
              bucket fold in both variants, K7 2^c doubling, K8 Horner
              combine) against its plain PyTorch version on the card,
              bit-exact, on seeded inputs plus edge values (zeros for
              mont_pow, identities, the pad pair and both signs for K4), at
              the main path's shapes (K1 in both fields at 2^14 and 2^17,
              dense and constant, and in every broadcast operand form;
              mont_pow in both fields at widths 1, 8 and 2^14;
              mont_scan also at 1, 16 and 3 rows; K4 and K5 also over a
              ragged lane count and at every team size, K5 also at the
              projective fused MSM's 3,328-26,624 lanes of 128 steps; K6
              at 1, 2, 4 and 8 columns and over 3 groups of 37 lanes, K7 at
              26-208 lanes and at 1,001 lanes of one doubling, each at every
              team size; K8 also at one column, at one window of one
              doubling and on identities only);
              timed as device time per launch (`ms`: launches replayed
              from a CUDA graph, cycling over copies of the inputs that
              overflow the L2, so operands come from HBM as `bound_ms`
              assumes; `l2_ms`: the same launch repeated on one set of
              inputs, which then sits in L2), as eager calls from Python
              (`eager_ms`) and, for the plain version, eagerly (`plain_ms`);
              then every kernel at the widths the k = 20 path (phase 8)
              launches it (K1 over 2^23 elements, K1's block scan over
              2^15 rows, K2 over one quotient group of 8 x 2^23, K4-K6 and
              K3 over one window group of 8 windows of 2^20 points, K3's
              tree, K7 and K8 over 32 columns of 16 windows, K9 over 2^20
              lanes): the kernel on the whole input, its plain version on
              the first and last lanes, bit-exact, timed (`kernel` lines
              with "path": "conv2d_mnist k=20")
4. prove   -- the main path at k = 14: gen_srs, keygen, create_proof(seed=1)
              of a circuit with a multiplication gate, a 256-entry lookup,
              copy constraints into the instance and a shuffle, filled over
              every usable row; verified by the port's host verifier, which
              must reject the proof with a tampered instance. Launch counts
              are reset just before gen_srs and create_proof and read just
              after each: K1 (all three forms) to K8 must be > 0 in
              create_proof (whose commitments run the fused MSM), K9 in
              gen_srs; K2 must run two passes per transform, K6, K7 and
              K8 once per fused MSM (5), K3 (single and tree) at most 20
              times. Then `resume`: the same seed-1 prove with a checkpoint
              directory, crashed as phase 5 starts and again as phase 6
              starts (`prover._span` made to raise), then run again; each
              resumed proof must equal the uninterrupted one byte for byte
              and the checkpoint must be cleared.
5. check   -- 2^14-point MSMs on the card against the host MSM: the fused
              pipeline on the SRS points (affine=True, as commitments run it,
              and affine=False) and the unfused one (K9 must be > 0 there);
              and an NTT round trip at 2^17
6. graph   -- the graded `mlp_4d` ONNX model (`examples/gen_graded.py`: the
              same weights and input from default_rng(42), built with the
              port's `onnx_writer`) through the port's file API on the card,
              in a temporary directory: gen_settings (RunArgs(logrows=14),
              every other argument at its default; the settings settle k),
              compile_circuit, gen_srs at the settled k, gen_witness, setup,
              prove(seed=1) cold and warm, verify; the verifier must reject
              the proof with its first eval's low bit flipped, and the
              witness's rescaled outputs must be within 4 * 2^-input_scale
              of the port's float forward of the model. Launch counts are
              reset just before the warm prove and read just after: K1-K8
              must be > 0 there, and K9 > 0 in gen_srs. Then the CLI
              (`python -m ezkl_tpu_torch prove` and `verify`, subprocesses,
              EZKL_TPU_DET_SEED=1, the default device) proves and verifies
              the same files, and its proof.json must be byte-equal to the
              API's seeded one.
8. conv2d_mnist -- the graded `conv2d_mnist` (`examples/gen_graded.py`,
              the draws of default_rng(7), the port's `onnx_writer`) through
              the file API on the card: gen_settings at the default run
              arguments (its k printed: 15), then `run_args.logrows` = 20
              in settings.json (the reference example's K), compile,
              gen_srs(20), gen_witness, setup, prove(seed=1) with a
              checkpoint directory cold and warm, verify; the flipped-eval
              proof rejected; the outputs within 0.5 of a float64 forward
              computed here, the same argmax; peak device memory below
              80 GB; K1-K8 launched in the warm prove, K9 in gen_srs(20).
              Seconds and peak bytes per step and per prover phase, the
              sizes of pk.key and of the checkpoint. Then the aggregate of
              this proof and the graph phase's mlp_4d proof (two vks):
              `verify_aggr` must accept it and reject it with an inner eval
              flipped.
9. evm    -- the EVM verifier, in the conv and graph phases' directories:
              conv2d_mnist at k = 20, keyed again with
              `disable_freivalds=True` on the conv phase's SRS (the EVM
              verifier takes no multi-phase circuit, in either package),
              api.prove(transcript="evm", seed=1) on the card (also
              verified by the host verifier with the EVM transcript), then
              create_evm_verifier, deploy_evm and verify_evm on the in-repo
              EVM, which must accept it and reject the copy with its first
              eval + 1 and the conv phase's default-transcript proof; then
              mlp_4d's EVM-transcript proof on the card through the CLI in
              subprocesses (create-evm-verifier, deploy-evm, verify-evm
              exit 0, encode-evm-calldata byte-equal to the API's), the
              tampered proof and the graph phase's default-transcript proof
              giving verify-evm exit 1, and calldata one byte
              short reverting on the port's EVM. Seconds of each step, the
              EVM prove's peak device bytes, runtime, initcode and calldata
              bytes; K1-K8 launched in each EVM prove.
10. mesh   -- `parallel.sharded` on `make_mesh(devices=[cuda:0] * 4)`, four
              shards standing in for four cards (and on up to four distinct
              cards where the machine has two or more), each against the
              single-device path: `msm_sharded` of the first 2^20 points of
              the conv phase's SRS with seeded scalars (affine-equal to
              `msm.msm_multi`), `ntt_sharded_batched` of 8 x 2^23 forward and
              inverse (word-equal to `ntt.ntt` / `ntt.intt`),
              `to_ext_sharded` of 8 columns of 2^20 (word-equal to
              `coeff_to_extended(intt(.))`), and the k = 14 stand-in's
              seed-1 proof with the mesh set (byte-equal to phase 4's, and
              verified; K1-K8 launched in it). Seconds of each beside the
              single-device ones.
11. families -- the models of `tests/torch_port_graph_models.py` through the
              file API on the card, each: gen_settings, compile, gen_srs,
              gen_witness, setup, prove(seed=1) cold and warm (the card
              widths: see below), verify, and a
              tampered proof (its first instance plus one; with no instance,
              its first eval's low bit flipped) rejected, with seconds, peak
              device bytes and K1-K9 launches per step (K1-K8 must run in
              the last prove, K9 in gen_srs). The card widths: a
              bidirectional LSTM (input 16, hidden 32, 8 steps) settling on
              k = 17 and a self-attention block (sequence 32, width 64)
              on k = 18, proved once here to keep the script's time
              (`tools/run_chip_phases.py families` proves them again warm
              and under torch.profiler for the device's busy time), their
              outputs within 0.15 and 0.25 of the float64 forward. The small models lstm_bidi,
              attn_small, gather_dyn (a gather whose table is advice),
              bmm_einsum and mlp_4d_kzg_io (committed input and output);
              where the JAX package's files are frozen
              (`tests/fixtures/torch_port/graph_<model>/`), settings.json,
              model.compiled, witness.json, vk.key and the seeded proof.json
              must equal them byte for byte. Then the split flow: mlp_4d's
              two parts (part 1's input is part 0's rescaled output on the
              card), their boundary commitments equal and carried in each
              proof, a doctored commitment swapped in refused and its proof
              rejected, the aggregate of the two part proofs accepted by
              `verify_aggr` and rejected with an inner eval flipped.
7. poseidon -- the device Poseidon `hash_fixed_len` over 2^14 two-element
              inputs on the card, bit-exact against `host_hash` on a sample
              of 64 of them; its products are K1 launches.

Then a `times` line (seconds of each phase), the `kernels` summary line
(times, bounds, launches: K1's three forms, K2, K3's two forms and K4-K8
from the graph phase's warm prove, K9 from its gen_srs; `standin_launches`
from phase 4's create_proof and gen_srs; `k20`: launches in the warm
conv2d_mnist prove (K9: gen_srs(20)), device ms and bound at its widths;
`evm_launches`: in the two EVM proves of phase 9; `mesh_launches`: in the
stand-in's prove under the four-shard mesh of phase 10; `families_launches`:
in each model's last prove of phase 11, K9 in its gen_srs),
the nvidia-smi line, and last `{"ok": true, "device": {...}}`. The phases
run in the order 3, 4 (with resume), 5, 6, 8, 9, 10, 11, 7.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
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


KERNEL_META = {
    "mont_mul": ("ezkl_tpu_torch/csrc/field.cu", "ezkl_tpu/fieldmath/limbs.py:682"),
    # K1's chain forms: the products of `pow_static` and of `prefix_scan_mul`'s
    # block scans, which the TPU ran through the same kernel in a `lax.scan`
    "mont_pow": ("ezkl_tpu_torch/csrc/field.cu", "ezkl_tpu/fieldmath/limbs.py:682"),
    "mont_scan": ("ezkl_tpu_torch/csrc/field.cu", "ezkl_tpu/fieldmath/limbs.py:682"),
    "ntt_stages": ("ezkl_tpu_torch/csrc/field.cu", "ezkl_tpu/kernels/pntt.py:31"),
    "point_add": ("ezkl_tpu_torch/csrc/curve.cu", "ezkl_tpu/kernels/pcurve.py:199"),
    # K3's tree form: the halving levels of `reduce_pairwise`, which the TPU
    # ran as one `_add_call` each
    "point_reduce": ("ezkl_tpu_torch/csrc/curve.cu", "ezkl_tpu/kernels/pcurve.py:199"),
    "point_dbl": ("ezkl_tpu_torch/csrc/curve.cu", "ezkl_tpu/kernels/pcurve.py:215"),
    "scan_packed": ("ezkl_tpu_torch/csrc/msm.cu", "ezkl_tpu/kernels/pcurve.py:322"),
    "scan_steps": ("ezkl_tpu_torch/csrc/msm.cu", "ezkl_tpu/kernels/pcurve.py:259"),
    "fold_lanes": ("ezkl_tpu_torch/csrc/msm.cu", "ezkl_tpu/kernels/pcurve.py:438"),
    "dbl_pow2": ("ezkl_tpu_torch/csrc/msm.cu", "ezkl_tpu/kernels/pcurve.py:647"),
    "horner": ("ezkl_tpu_torch/csrc/msm.cu", "ezkl_tpu/kernels/pcurve.py:557"),
}
POINT_KERNELS = ("point_add", "point_reduce", "point_dbl", "scan_packed", "scan_steps",
                 "fold_lanes", "dbl_pow2", "horner")
# The fused MSMs of a k = 14 prove (one per `kzg.commit_many`): each
# launches K6, K7 and K8 once
FUSED_MSMS = 5
# K3's launches per k = 14 prove: each fused MSM adds the bucket combine, the
# prefix combine and V once each and runs the halving tree once
K3_LAUNCHES_MAX = 4 * FUSED_MSMS


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


def timings(kernel, inputs, plain, reps=GRAPH_REPS):
    """`ms` (operands from HBM), `l2_ms`, `eager_ms` and `plain_ms`; `reps`
    launches per graph (each keeps its output)."""
    return dict(ms=device_ms(kernel, inputs, reps=reps),
                l2_ms=device_ms(kernel, inputs, cold=False, reps=reps),
                eager_ms=time_ms(lambda: kernel(*inputs), min(REPS, reps)),
                plain_ms=time_ms(lambda: plain(*inputs), 3))


def bound(nbytes, imad):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, imad / IMAD_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def run_kernel(name, kern, plain, inputs, nbytes, imad, reps=GRAPH_REPS, **extra):
    """One `kernel` line: `kern` against `plain` on `inputs` (bit-exact or
    raise), device times, and the bound of `nbytes` moved and `imad`
    multiply-adds. Returns the line's row."""
    err = max_abs_err(_outputs(kern(*inputs)), _outputs(plain(*inputs)))
    row = dict(max_abs_err=err, **extra, **timings(kern, inputs, plain, reps))
    row["bound_ms"], row["bound_by"] = bound(nbytes, imad)
    emit({"phase": "kernel", "kernel": name, **row})
    if err:
        raise AssertionError(f"{name} kernel != plain ({extra})")
    return row


def team_sweep(name, launch, teams, inputs, want, nbytes, imad, reps, **shape):
    """`launch(team)`, a kernel of `inputs`, at every team size in `teams`:
    bit-exact against `want` (or raise) and timed, one `team_sweep` line
    each."""
    for team in teams:
        kern = launch(team)
        err = max_abs_err(_outputs(kern(*inputs)), _outputs(want))
        row = dict(max_abs_err=err, team=team, **shape, ms=device_ms(kern, inputs, reps=reps),
                   l2_ms=device_ms(kern, inputs, cold=False, reps=reps))
        row["bound_ms"], row["bound_by"] = bound(nbytes, imad)
        emit({"phase": "kernel", "kernel": name, "team_sweep": True, **row})
        if err:
            raise AssertionError(f"{name} kernel != plain (team {team}, {shape})")


def _outputs(out):
    """A kernel's result as a list of tensors (a field array or a point)."""
    import torch
    return [out] if isinstance(out, torch.Tensor) else list(out)


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
    from ezkl_tpu_torch.fieldmath import curve
    from ezkl_tpu_torch.kernels import pcurve, build

    rows = {"mont_mul": check_mont_mul(dev, rng)}
    rows.update(check_field_chains(dev, rng))

    rows.update(check_ntt_stages(dev, rng))

    # K3 on projective multiples of G1 with nontrivial Z, plus edges, and K9
    # on the same points against the group law
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
        row = run_kernel("point_add", lambda *t: pcurve._add_launch(t, pcurve.point_add_team(n)),
                         lambda *t: pcurve.point_add_plain(curve.PointP(*t[:3]),
                                                           curve.PointP(*t[3:])),
                         [*P2, *Q], 9 * 32 * n, 12 * IMAD_PER_MONT_MUL * n, n=n,
                         team=pcurve.point_add_team(n))
        if n == 1 << 14:
            rows["point_add"] = row
        # the edge lanes against the group law itself
        s = curve.decode_points(pcurve.point_add(P2, Q).map(lambda t: t[:, :4]))
        p0 = curve.decode_points(P.map(lambda t: t[:, :2]))
        d = curve.decode_points(pcurve.point_dbl(P).map(lambda t: t[:, 1:2]))
        if not (s[0] == p0[0] and s[1] == d[0] and s[2] is None and s[3] is None):
            raise AssertionError("point_add edge lanes wrong")
    rows["point_dbl"] = check_point_dbl(dev, rng)
    rows.update(check_point_adds(dev, rng))
    rows.update(check_msm_kernels(dev, rng))
    build.reset_launches()        # comparison launches do not count
    return rows


def check_mont_mul(dev, rng):
    """K1 elementwise against its plain version, bit-exact. At the prove's
    2^14 and 2^17 elements, in both fields: dense and constant operands
    (timed), and every broadcast form (`limbs.bcast_form`), either operand
    side. Returns the dense Fr row at 2^17."""
    from ezkl_tpu_torch.fieldmath import limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr, bn254_fq

    mm = IMAD_PER_MONT_MUL
    out = None
    for spec in (bn254_fr(), bn254_fq()):
        kern = lambda x, y, spec=spec: limbs._mont_mul_kernel(spec, x, y)   # noqa: E731
        plain = lambda x, y, spec=spec: limbs.mont_mul_plain(spec, x, y)    # noqa: E731
        for n in (1 << 14, 1 << 17):
            a, b = field_inputs(spec, n, rng, dev)
            b = b.contiguous()
            c = limbs.bcast_const(spec, 12345, 1, device=dev)
            row = run_kernel("mont_mul", kern, plain, [a, b], 3 * 32 * n, mm * n,
                             field=spec.name, n=n, b="dense")
            if spec.name == "bn254_fr" and n == 1 << 17:
                out = row
            run_kernel("mont_mul", kern, plain, [a, c], 2 * 32 * n + 32, mm * n, field=spec.name,
                       n=n, b="constant")
            # the broadcast operand read in place, in the forms the prover
            # gives it
            w = n // 8
            x = field_inputs(spec, n, rng, dev)[0].reshape(8, 8, w)
            forms = {"constant": limbs.bcast_const(spec, 12345, 2, device=dev),
                     "row": field_inputs(spec, w, rng, dev)[0].reshape(8, 1, w),
                     "column": x[:, :, :1],
                     "expanded": limbs.ones_mont(spec, (8, w), dev),
                     "both": (x[:, :1, :], x[:, :, :1])}
            for form, y in forms.items():
                lhs, rhs = y if form == "both" else (x, y)
                want = plain(lhs, rhs)
                for u, v in ((lhs, rhs), (rhs, lhs)):
                    if max_abs_err([kern(u, v)], [want]):
                        raise AssertionError(f"mont_mul kernel != plain (broadcast {form}, "
                                             f"{spec.name}, n={n})")
            emit({"phase": "kernel", "kernel": "mont_mul", "field": spec.name, "n": n,
                  "broadcast_forms_checked": sorted(forms), "max_abs_err": 0})
    return out


# K9's widths: the ones its paths launch at k = 14 -- 1 and 26 lanes (the
# unfused MSM's doublings of its C = 1 accumulator and of its C x W = 26
# window sums) and 2^14 (`gen_srs`) -- and 2^13, the other side of
# `pcurve.DBL_TEAM4_LANES`, and 2^17, which no path here launches (`gen_srs`
# at k = 17 would), the width of the parent's K9 line
DBL_LANES = (1, 26, 1 << 13, 1 << 14, 1 << 17)


def dbl_inputs(P, n, dev, rng):
    """n lanes of K9's input: points of the pool P at random, identity lanes
    first, last (from 26 lanes) and ~5% at random. A list of 3 coordinates."""
    import torch
    from ezkl_tpu_torch.fieldmath import limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fq

    zero = torch.zeros(8, dtype=torch.int32, device=dev)
    ident = (zero, limbs.const(bn254_fq(), 1, device=dev), zero)
    mask = torch_index(rng.random(n) < 0.05, dev).bool()
    if n > 1:
        mask[0] = mask[-1] = True
    idx = torch_index(rng.integers(0, P.x.shape[1], size=n), dev)
    return list(_set(_gather(P, idx), mask, ident))


def check_point_dbl(dev, rng):
    """K9 against its plain version, bit-exact, on multiples of G1 with
    nontrivial Z and identity lanes (first, last and ~5% at random, from 26
    lanes): at every width of `DBL_LANES`, one `team_sweep` line per team
    size of `pcurve.DBL_TEAMS`, then with the team `pcurve.dbl_team` picks,
    timed. Returns the row at 2^14."""
    from ezkl_tpu_torch.fieldmath import curve
    from ezkl_tpu_torch.kernels import pcurve

    P, _ = _pool(dev, rng)
    out = None
    for n in DBL_LANES:
        inputs = dbl_inputs(P, n, dev, rng)
        plain = lambda *t: pcurve.point_dbl_plain(curve.PointP(*t))   # noqa: E731
        nbytes, imad = 6 * 32 * n, 8 * IMAD_PER_MONT_MUL * n
        team_sweep("point_dbl", lambda team: lambda *t: pcurve._dbl_launch(t, team),
                   pcurve.DBL_TEAMS, inputs, plain(*inputs), nbytes, imad, GRAPH_REPS, lanes=n)
        team = pcurve.dbl_team(n)
        row = run_kernel("point_dbl", lambda *t: pcurve._dbl_launch(t, team), plain, inputs,
                         nbytes, imad, lanes=n, team=team)
        if n == 1 << 14:
            out = row
    return out


# The prove's transforms at k = 14: 2^14 points, one column (the iNTTs of
# single polynomials) or 8 (the batched domain changes), and 16 columns of
# the 2^17-point extended domain.
NTT_SHAPES = ((1, K), (8, K), (16, 17))


def check_ntt_stages(dev, rng):
    """K2 against its plain version, bit-exact: every pass (s0, r) of every
    k = 1 .. 17, forward and inverse, over two columns; `bfly` (r = 1) at
    three stage widths. Then per whole transform at the prove's shapes
    (`NTT_SHAPES`): a `kernel` line for its passes (the K2 launches of one
    NTT, on its bit-reversed input) and a sweep of the groups per block of
    each pass. Returns the row at one column of 2^14."""
    import torch
    from ezkl_tpu_torch.fieldmath import limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr
    from ezkl_tpu_torch.kernels import ntt, pntt

    FR = bn254_fr()

    def elements(n):
        return limbs.to_device(limbs.encode(FR, [
            int.from_bytes(rng.bytes(32), "little") % FR.modulus for _ in range(n)]), dev)

    checked = 0
    for k in range(1, 18):
        for inverse in (False, True):
            tw = ntt.twiddles(FR, k, inverse, dev)
            x = elements(2 << k).reshape(8, 2, 1 << k)
            for s0 in range(k):
                want = x
                for r in range(1, min(pntt.MAX_STAGES, k - s0) + 1):
                    want = pntt.bfly_plain(FR, want, pntt.stage_twiddles(tw, k, s0 + r))
                    if max_abs_err([pntt._stages_kernel(FR, x, tw, k, s0, r)], [want]):
                        raise AssertionError(f"ntt_stages kernel != plain (k={k}, s0={s0}, "
                                             f"r={r}, inverse={inverse})")
                    checked += 1
    x = elements(1 << 17)
    for log_half in (0, 5, 16):
        w = elements(1 << log_half)
        if max_abs_err([pntt.bfly(FR, x, w)], [pntt.bfly_plain(FR, x, w)]):
            raise AssertionError(f"bfly kernel != plain (half=2^{log_half})")
    emit({"phase": "kernel", "kernel": "ntt_stages", "passes_checked": checked, "k": "1-17",
          "directions": ["forward", "inverse"], "columns": 2,
          "bfly_halves_checked": [1, 32, 1 << 16], "max_abs_err": 0})

    rows = {}
    for cols, k in NTT_SHAPES:
        n = 1 << k
        tw = ntt.twiddles(FR, k, False, dev)
        split = pntt.pass_split(k)
        x = elements(cols * n).reshape(8, cols, n)[..., ntt._bitrev(k, dev)].contiguous()

        def kern(y, split=split, tw=tw, k=k):
            for s0, r in split:
                y = pntt._stages_kernel(FR, y, tw, k, s0, r)
            return y

        def plain(y, split=split, tw=tw, k=k):
            for s0, r in split:
                y = pntt.stages_plain(FR, y, tw, k, s0, r)
            return y

        row = run_kernel("ntt_stages", kern, plain, [x], len(split) * 2 * 32 * cols * n,
                         k * (n // 2) * cols * IMAD_PER_MONT_MUL, reps=20, field=FR.name,
                         columns=cols, k=k, passes=len(split), launches_per_ntt=len(split),
                         whole_ntt=True)
        if (cols, k) == (1, K):
            rows["ntt_stages"] = row
        for s0, r in split:
            chosen = pntt.groups_per_block(cols, k, s0, r)
            cap = pntt.max_log_groups(k, s0, r)
            for log_gb in range(cap + 1):
                one = lambda y, s0=s0, r=r, g=log_gb: pntt._stages_kernel(   # noqa: E731
                    FR, y, tw, k, s0, r, g)
                emit({"phase": "kernel", "kernel": "ntt_stages", "gb_sweep": True,
                      "columns": cols, "k": k, "s0": s0, "r": r, "groups_per_block": 1 << log_gb,
                      "chosen": log_gb == chosen,
                      "ms": device_ms(one, [x], reps=20),
                      "l2_ms": device_ms(one, [x], cold=False, reps=20),
                      "bound_ms": bound(2 * 32 * cols * n, r * (n // 2) * cols *
                                        IMAD_PER_MONT_MUL)[0]})
        del x
    return rows


def check_field_chains(dev, rng):
    """K1's chain forms against their plain versions, bit-exact: `mont_pow`
    (a^(p-2), a Fermat inversion) in both fields at widths 1, 8 and 2^14,
    zeros in the batch (and a single zero), and `mont_scan` at (rows, steps)
    = (1, 32), (16, 32), (512, 32) -- the block scans of a 2^14 prefix
    product -- and (3, 17). Returns the rows of the main path's commonest
    shapes: an Fr inversion of one element, the 512 x 32 block scan."""
    from ezkl_tpu_torch.fieldmath import limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr, bn254_fq

    FR, FQ = bn254_fr(), bn254_fq()
    rows = {}

    def elements(spec, n):
        vals = [int.from_bytes(rng.bytes(32), "little") % spec.modulus for _ in range(n)]
        if n > 1:
            vals[0] = vals[n // 2] = 0
        return limbs.to_device(limbs.encode(spec, vals), dev)

    for spec in (FR, FQ):
        e = spec.modulus - 2
        products = limbs.pow_schedule(e)[3]
        kern = lambda x: limbs._mont_pow_kernel(spec, x, e)          # noqa: E731
        plain = lambda x: limbs.pow_static_plain(spec, x, e)         # noqa: E731
        zero = limbs.zeros((1,), dev)
        if max_abs_err([kern(zero)], [plain(zero)]):
            raise AssertionError(f"mont_pow kernel != plain (inverse of zero, {spec.name})")
        for n in (1, 8, 1 << 14):
            row = run_kernel("mont_pow", kern, plain, [elements(spec, n)], 64 * n,
                             products * IMAD_PER_MONT_MUL * n, reps=20, field=spec.name, n=n,
                             exponent="p-2", products=products)
            if spec is FR and n == 1:
                rows["mont_pow"] = row
    for r, steps in ((1, 32), (16, 32), (512, 32), (3, 17)):
        v = elements(FR, r * steps).reshape(8, r, steps)
        row = run_kernel("mont_scan", lambda x: limbs._mont_scan_kernel(FR, x),
                         lambda x: limbs.seq_scan_mul_plain(FR, x), [v], 64 * r * steps,
                         (steps - 1) * IMAD_PER_MONT_MUL * r, reps=20, field=FR.name, rows=r,
                         steps=steps)
        if r == 512:
            rows["mont_scan"] = row
    return rows


def check_point_adds(dev, rng):
    """K3 at the fused MSM's widths, bit-exact against the plain versions,
    with identity lanes: the tree form at G = 26 and 208 groups of w = 128
    partials (one column and eight), and the single add at every width the
    k = 14 prove launches it (the bucket combine at C * 13,312 lanes, the
    prefix combine at C * 3,328, V at C * 26, C = 1 or 8) and at 1,664, each
    at every team size, then at the size `point_add_team` picks with the
    plain version timed. Returns the tree's row at G = 208."""
    import torch
    from ezkl_tpu_torch.fieldmath import curve, limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fq
    from ezkl_tpu_torch.kernels import pcurve

    P, _ = _pool(dev, rng)
    zero = torch.zeros(8, dtype=torch.int32, device=dev)
    ident = (zero, limbs.const(bn254_fq(), 1, device=dev), zero)
    mm = IMAD_PER_MONT_MUL
    rows = {}

    def points(*shape):
        idx = torch_index(rng.integers(0, P.x.shape[1], size=shape), dev)
        mask = torch_index(rng.random(shape) < 0.05, dev).bool()
        mask.view(-1)[0] = True
        return list(_set(_gather(P, idx), mask, ident))

    for G in (MSM_W, 8 * MSM_W):
        w = 128
        row = run_kernel("point_reduce", lambda *t: pcurve._reduce_kernel(curve.PointP(*t)),
                         lambda *t: pcurve.reduce_pairwise_plain(curve.PointP(*t)),
                         points(G, w), 3 * 32 * G * w + 96 * G, 12 * mm * (w - 1) * G,
                         reps=20, groups=G, w=w)
        rows["point_reduce"] = row
    for n in (106496, 26624, 13312, 3328, 1664, 208, 26):
        inputs = points(n) + points(n)
        nbytes, imad = 9 * 32 * n, 12 * mm * n
        team_sweep("point_add", lambda team: lambda *t: pcurve._add_launch(t, team),
                   pcurve.ADD_TEAMS, inputs,
                   pcurve.point_add_plain(curve.PointP(*inputs[:3]), curve.PointP(*inputs[3:])),
                   nbytes, imad, 20, lanes=n)
        run_kernel("point_add", lambda *t: pcurve._add_launch(t, pcurve.point_add_team(n)),
                   lambda *t: pcurve.point_add_plain(curve.PointP(*t[:3]),
                                                     curve.PointP(*t[3:])),
                   inputs, nbytes, imad, reps=20, lanes=n, team=pcurve.point_add_team(n))
    return rows


# The fused MSM at k = 14 (n = 2^14, c = 10, so W = 26 signed windows, B = 512
# buckets, S = 128 scan steps) over C committed columns: K4 scans C * 26 *
# 2^14 / 128 = C * 3,328 lanes of 128 steps; the block-total prefix runs K5
# on C * 104 lanes of 32 steps (then C * 26 lanes of 4); K6 folds each
# window's 512 bucket sums in 4 chunks of 128 lanes; K7 doubles C * 26
# window totals 9 times; K8 combines 26 windows at c = 10 over C columns.
MSM_N, MSM_C, MSM_W, MSM_S = 1 << K, 10, 26, 128


def _pool(dev, rng, n=1 << 12):
    """Projective multiples of G1 with nontrivial Z, and their affine (x, y)."""
    import torch
    from ezkl_tpu_torch.fieldmath import curve
    bits = torch_index(rng.integers(0, 2, size=(64, n)), dev).to(torch.int32)
    P = curve.scalar_mul(curve.generator((n,), dev), bits)
    return P, curve.to_affine(P)


def _gather(coords, idx):
    return tuple(c[:, idx].contiguous() for c in coords)


def _set(coords, mask, values):
    """coords with the lanes of `mask` (batch bool) set to `values` ((8,) each)."""
    import torch
    return tuple(torch.where(mask[None], v.reshape((8,) + (1,) * mask.dim()), c).contiguous()
                 for c, v in zip(coords, values))


def check_msm_kernels(dev, rng):
    """K4-K8 against their plain versions at the k = 14 main path's shapes,
    bit-exact, with edge lanes; one `kernel` line each (both variants of K5
    and K6; K4 at C = 1, 2, 4 and 8 and over a ragged 1,001 lanes, each
    also at every team size; K5 at every team size also at the projective
    fused MSM's scan of C = 1, 2 and 8 columns; K6 at C = 1, 2, 4 and 8
    and over 3 groups of 37 lanes, K7 at C = 1, 2, 4 and 8 and over 1,001
    lanes of one doubling, each also at every team size; K8 also at one
    column, at W = 1 with c = 1 and with every V_w the identity). Returns
    the rows at C = 8."""
    import torch
    from ezkl_tpu_torch.fieldmath import curve, limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fq
    from ezkl_tpu_torch.kernels import pcurve

    FQ = bn254_fq()
    P, (ax, ay) = _pool(dev, rng)
    zero = torch.zeros(8, dtype=torch.int32, device=dev)
    one = limbs.const(FQ, 1, device=dev)
    ident = (zero, one, zero)
    rows = {}

    def rand_idx(*shape):
        return torch_index(rng.integers(0, P.x.shape[1], size=shape), dev)

    mm = IMAD_PER_MONT_MUL

    def scan_inputs(L):
        """K4's inputs over L lanes of 128 steps: pad pairs (0, 1) at a first
        step, a later step, over a whole lane and in the last lane; both
        signs. Returns them with the count of adds they need."""
        x, y = _gather((ax, ay), rand_idx(MSM_S, L))
        pad = torch.zeros(MSM_S, L, dtype=torch.bool, device=dev)
        pad[0, 0] = pad[5, 1] = pad[7, L - 1] = True
        pad[:, 2] = True
        x, y = _set((x, y), pad, (zero, one))
        sn = torch_index(rng.integers(0, 2, size=(MSM_S, L)), dev).to(torch.int32)
        return [x, y, sn], int((~pad[1:]).sum())

    def scan_teams(inputs, L, **extra):
        """K4 at every team size on one input: bit-exact, device times."""
        team_sweep("scan_packed", lambda team: lambda *t: pcurve._scan_packed_launch(*t, team),
                   pcurve.SCAN_TEAMS, inputs, pcurve.scan_packed_plain(*inputs),
                   (2 * 32 + 4 + 96) * MSM_S * L, 11 * mm * extra.pop("adds"), 5, lanes=L,
                   steps=MSM_S, **extra)

    for C in (1, 2, 4, 8):
        # K4 at the lanes of the prove's commitments (C = 1 to 8 columns),
        # with the team `lane_team` picks, then at every team size
        L = C * MSM_W * MSM_N // MSM_S
        inputs, adds = scan_inputs(L)
        row = run_kernel("scan_packed", pcurve._scan_packed_kernel, pcurve.scan_packed_plain,
                         inputs, (2 * 32 + 4 + 96) * MSM_S * L, 11 * mm * adds,
                         reps=20 if C == 1 else 5, columns=C, lanes=L, steps=MSM_S,
                         team=pcurve.lane_team(L))
        scan_teams(inputs, L, columns=C, adds=adds)
        del inputs
    rows["scan_packed"] = row
    # K4 over a lane count that is no multiple of any team size's lanes per
    # block (the ragged last block)
    L = 1001
    inputs, adds = scan_inputs(L)
    run_kernel("scan_packed", pcurve._scan_packed_kernel, pcurve.scan_packed_plain, inputs,
               (2 * 32 + 4 + 96) * MSM_S * L, 11 * mm * adds, reps=20, lanes=L, steps=MSM_S,
               team=pcurve.lane_team(L))
    scan_teams(inputs, L, adds=adds)
    del inputs

    C = 8
    G = C * MSM_W

    point = lambda t: curve.PointP(*t) if len(t) == 3 else t            # noqa: E731

    def steps_teams(variant, inputs, L, S, nbytes, imad, **extra):
        """K5 at every team size on one input: bit-exact, device times."""
        team_sweep("scan_steps", lambda team: lambda *t: pcurve._scan_steps_launch(point(t),
                                                                                  team),
                   pcurve.SCAN_TEAMS, inputs, pcurve.scan_steps_plain(point(inputs)), nbytes,
                   imad, 20 if L * S <= 1 << 16 else 5, variant=variant, lanes=L, steps=S,
                   **extra)

    def steps_inputs(L, S):
        """K5's inputs over L lanes of S steps: projective with identities at
        a first step, a later step, over a whole lane and in the last lane;
        and the affine pairs of the same points."""
        idx = rand_idx(S, L)
        mask = torch.zeros(S, L, dtype=torch.bool, device=dev)
        mask[0, 0] = mask[3, 1] = mask[5, L - 1] = True
        mask[:, 2] = True
        return list(_set(_gather(P, idx), mask, ident)), list(_gather((ax, ay), idx))

    # K5 at the block-total prefix's first level: C * 104 lanes x 32 steps,
    # with the team `lane_team` picks, then at every team size; and
    # over a lane count that fills no block of either team size
    S = 32
    for L in (G * 4, 1001):
        Pq, Pa = steps_inputs(L, S)
        for variant, inputs, nin, muls in (("complete", Pq, 3, 12), ("mixed", Pa, 2, 11)):
            nbytes, imad = (nin + 3) * 32 * S * L, muls * mm * (S - 1) * L
            row = run_kernel("scan_steps", lambda *t: pcurve._scan_steps_kernel(point(t)),
                             lambda *t: pcurve.scan_steps_plain(point(t)), inputs, nbytes,
                             imad, variant=variant, **({"columns": C} if L == G * 4 else {}),
                             lanes=L, steps=S, team=pcurve.lane_team(L))
            if variant == "complete" and L == G * 4:
                rows["scan_steps"] = row
            steps_teams(variant, inputs, L, S, nbytes, imad)
        del Pq, Pa

    # K5 at the projective fused MSM's own scan (`msm.msm(..., affine=False)`,
    # as the check phase runs it): 3,328 lanes of 128 steps per column, at
    # 1, 2 and 8 columns, every team size; the lane counts where the team
    # that wins may change
    for Cp in (1, 2, 8):
        L = Cp * MSM_W * MSM_N // MSM_S
        Pq, _ = steps_inputs(L, MSM_S)
        steps_teams("complete", Pq, L, MSM_S, 6 * 32 * MSM_S * L, 12 * mm * (MSM_S - 1) * L,
                    columns=Cp)
        del Pq

    # K6 over the B = 512 bucket sums of every window: C * 26 groups of 4
    # chunks of 128 lanes, complete at the C = 1, 2, 4 and 8 columns of the
    # prove's commitments and mixed at C = 8, with the team
    # `lane_team` picks, then at every team size; and 3 groups of 37
    # lanes, which fill no block of any team size
    def fold(variant, Gf, chunks, blk, **extra):
        idx = rand_idx(Gf, chunks * blk)
        if variant == "complete":
            mask = torch_index(rng.random((Gf, chunks * blk)) < 0.05, dev).bool()
            mask[0, 0] = True
            inputs, nin, muls = list(_set(_gather(P, idx), mask, ident)), 3, 12
        else:
            inputs, nin, muls = list(_gather((ax, ay), idx)), 2, 11
        lanes = Gf * blk
        nbytes, imad = (nin * chunks + 3) * 32 * lanes, muls * mm * (chunks - 1) * lanes
        shape = dict(variant=variant, **extra, groups=Gf, chunks=chunks, blk=blk, lanes=lanes)
        row = run_kernel("fold_lanes", lambda *t: pcurve._fold_lanes_kernel(point(t), blk),
                         lambda *t: pcurve.fold_lanes_plain(point(t), blk), inputs, nbytes,
                         imad, reps=20, **shape, team=pcurve.lane_team(lanes))
        team_sweep("fold_lanes", lambda team: lambda *t: pcurve._fold_lanes_launch(
                       point(t), blk, team), pcurve.SCAN_TEAMS, inputs,
                   pcurve.fold_lanes_plain(point(inputs), blk), nbytes, imad, 20, **shape)
        return row

    for Cf in (1, 2, 4, 8):
        row = fold("complete", Cf * MSM_W, 4, 128, columns=Cf)
    rows["fold_lanes"] = row
    fold("mixed", G, 4, 128, columns=C)
    fold("complete", 3, 4, 37)
    fold("mixed", 3, 4, 37)

    # K7: 2^(c-1) * T_w over the C * 26 window totals, c = 10, at C = 1, 2, 4
    # and 8; and one doubling over 1,001 lanes; identity lanes first and last
    def dbl(n, c, **extra):
        ends = torch.zeros(n, dtype=torch.bool, device=dev)
        ends[0] = ends[-1] = True
        inputs = list(_set(_gather(P, rand_idx(n)), ends, ident))
        return run_kernel("dbl_pow2", lambda *t: pcurve._dbl_pow2_kernel(curve.PointP(*t), c),
                          lambda *t: pcurve.dbl_pow2_plain(curve.PointP(*t), c), inputs,
                          6 * 32 * n, c * 8 * mm * n, **extra, lanes=n, c=c)

    for Cd in (1, 2, 4, 8):
        row = dbl(Cd * MSM_W, MSM_C - 1, columns=Cd)
    rows["dbl_pow2"] = row
    dbl(1001, 1)

    # K8: W = 26 windows at c = 10 over C columns; then one column, one
    # window of one doubling, and every V_w the identity
    def horner(W, c, width, mask, **extra):
        V = _set(_gather(P, rand_idx(W, width)), mask, ident)
        return run_kernel("horner", lambda *t: pcurve._horner_kernel(curve.PointP(*t), c),
                          lambda *t: pcurve.horner_plain(curve.PointP(*t), c),
                          list(V), 3 * 32 * (W + 1) * width, W * (c * 8 + 12) * mm * width,
                          windows=W, c=c, width=width, **extra)

    mask = torch.zeros(MSM_W, C, dtype=torch.bool, device=dev)
    mask[0, 0] = mask[3, 2] = True
    rows["horner"] = horner(MSM_W, MSM_C, C, mask)
    mask = torch.zeros(MSM_W, 1, dtype=torch.bool, device=dev)
    mask[3, 0] = True
    horner(MSM_W, MSM_C, 1, mask)
    horner(1, 1, C, torch.zeros(1, C, dtype=torch.bool, device=dev))
    horner(MSM_W, MSM_C, C, torch.ones(MSM_W, C, dtype=torch.bool, device=dev),
           all_identity=True)
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
    from ezkl_tpu_torch.kernels import build, ntt, pntt
    from ezkl_tpu_torch.plonk import keygen, prover, srs as srsmod, verifier

    cs, asg, use = build_circuit(rng)
    build.reset_launches()
    t0 = time.perf_counter()
    srs = srsmod.gen_srs(K, device=dev)
    torch.cuda.synchronize()
    t_srs = time.perf_counter() - t0
    srs_launches = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    pk = keygen.keygen(cs, K, srs, asg, device=dev)
    torch.cuda.synchronize()
    t_keygen = time.perf_counter() - t0

    # count the transforms of the prove and the K2 passes they need
    transforms = {"calls": 0, "passes": 0}
    plain_ntt = ntt.ntt

    def counted_ntt(spec, coeffs, inverse=False):
        if coeffs.shape[-1] > 1 and coeffs.numel():
            transforms["calls"] += 1
            transforms["passes"] += len(pntt.pass_split(coeffs.shape[-1].bit_length() - 1))
        return plain_ntt(spec, coeffs, inverse)

    torch.cuda.reset_peak_memory_stats()
    ntt.ntt = counted_ntt
    build.reset_launches()
    try:
        t0 = time.perf_counter()
        proof = prover.create_proof(pk, srs, asg, seed=SEED)
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        ntt.ntt = plain_ntt

    t0 = time.perf_counter()
    ok = verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
    t_verify = time.perf_counter() - t0
    bad = dataclasses.replace(proof, instances=[[(proof.instances[0][0] + 1)]])
    rejected = not verifier.verify(pk.vk, srs.g2, srs.s_g2, bad)
    emit({"phase": "prove", "k": K, "extended_k": pk.vk.domain.extended_k,
          "rows_used": use,
          "srs_s": t_srs, "keygen_s": t_keygen, "prove_s": t_prove, "verify_s": t_verify,
          "prove_phases_s": dict(prover.PHASE_SECONDS),
          "peak_mem_bytes": max(prover.PHASE_PEAK_BYTES.values()),
          "phase_peak_bytes": dict(prover.PHASE_PEAK_BYTES),
          "launches": launches, "gen_srs_launches": srs_launches,
          "point_launches": sum(launches[k] for k in POINT_KERNELS),
          "ntt_calls": transforms["calls"], "ntt_passes": transforms["passes"],
          "k3_launches": launches["point_add"] + launches["point_reduce"],
          "verified": ok, "tampered_rejected": rejected})
    if not ok:
        raise AssertionError("the port's verifier rejected the k=14 proof")
    if not rejected:
        raise AssertionError("the verifier accepted a proof with a tampered instance")
    missing = [k for k in launches if k != "point_dbl" and launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by create_proof: {missing}")
    if srs_launches["point_dbl"] <= 0:
        raise AssertionError("point_dbl not launched by gen_srs")
    if not (launches["ntt_stages"] == transforms["passes"] == 2 * transforms["calls"]):
        raise AssertionError(f"ntt_stages launched {launches['ntt_stages']} times for "
                             f"{transforms['calls']} transforms of 2 passes each")
    once = {k: launches[k] for k in ("fold_lanes", "dbl_pow2", "horner")}
    if set(once.values()) != {FUSED_MSMS}:
        raise AssertionError(f"K6, K7, K8 launched {once} times, not once per fused MSM "
                             f"({FUSED_MSMS})")
    if launches["point_add"] + launches["point_reduce"] > K3_LAUNCHES_MAX:
        raise AssertionError(f"K3 launched {launches['point_add']} + "
                             f"{launches['point_reduce']} times, above {K3_LAUNCHES_MAX}")
    return srs, launches, srs_launches, (pk, asg, proof.to_json())


# ---------------------------------------------------------------------------
# phase 5: outputs against references
# ---------------------------------------------------------------------------

def check_outputs(dev, rng, srs):
    """Returns the launch counts of the unfused MSM's run."""
    import torch
    from ezkl_tpu_torch.fieldmath import limbs, curve, hostcurve, native
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr
    from ezkl_tpu_torch.kernels import build, msm, ntt

    FR = bn254_fr()
    n = 1 << K if native.available() else 256
    pts = srs.g1.map(lambda t: t[:, :n].contiguous())
    scal = [int.from_bytes(rng.bytes(32), "little") % FR.modulus for _ in range(n)]
    S = limbs.to_device(limbs.encode(FR, scal, mont=False), dev)
    want = hostcurve.g1_msm(curve.decode_points(pts), scal)
    runs = {"fused_affine": lambda: msm.msm(pts, S, affine=True),
            "fused_projective": lambda: msm.msm(pts, S, affine=False),
            "unfused": lambda: msm.msm_multi_unfused(pts, S[None]).map(lambda t: t[..., 0])}
    matches, seconds = {}, {}
    for name, fn in runs.items():
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        matches[name] = curve.decode_points(out.map(lambda t: t[:, None]))[0] == want
    unfused_launches = dict(build.LAUNCHES)
    x, _ = field_inputs(FR, 1 << 17, rng, dev)
    round_trip = torch.equal(ntt.intt(FR, ntt.ntt(FR, x)), x)
    small = limbs.to_device(limbs.encode(FR, scal[:64]), dev)
    ntt_ok = list(limbs.decode(FR, ntt.ntt(FR, small))) == ntt.host_ntt(FR, scal[:64])
    emit({"phase": "check", "msm_n": n, "msm_matches_host": matches, "msm_s": seconds,
          "unfused_msm_launches": unfused_launches,
          "ntt_round_trip_2^17": round_trip, "ntt_64_matches_host": ntt_ok})
    if not (all(matches.values()) and round_trip and ntt_ok):
        raise AssertionError("device outputs disagree with the host references")
    if unfused_launches["point_dbl"] <= 0:
        raise AssertionError("point_dbl not launched by the unfused MSM")
    return unfused_launches


# ---------------------------------------------------------------------------
# phase 6: the graded mlp_4d model through the file API and the CLI
# ---------------------------------------------------------------------------

GRAPH_MODEL = "mlp_4d"
GRAPH_LOGROWS = 14


def mlp_4d_draws():
    """`examples/gen_graded.py`'s mlp_4d initializers (Gemm weights stored
    transposed) and input: the same draws of default_rng(42) in the same
    order."""
    rng = np.random.default_rng(42)
    w0 = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    b0 = rng.uniform(-0.5, 0.5, (4,)).astype(np.float32)
    w1 = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    b1 = rng.uniform(-0.5, 0.5, (4,)).astype(np.float32)
    x = rng.uniform(-1, 1, (1, 4)).astype(np.float64)
    return {"w0": w0.T.copy(), "b0": b0, "w1": w1.T.copy(), "b1": b1}, x


def mlp_4d(writer):
    """`examples/gen_graded.py`'s mlp_4d with `writer` (an `onnx_writer`):
    (onnx bytes, input.json dict)."""
    weights, x = mlp_4d_draws()
    nodes = [
        writer.node("Gemm", ["x", "w0", "b0"], ["h0"], name="l0"),
        writer.node("Relu", ["h0"], ["a0"], name="relu0"),
        writer.node("Gemm", ["a0", "w1", "b1"], ["h1"], name="l1"),
        writer.node("Relu", ["h1"], ["y"], name="relu1"),
    ]
    onnx = writer.model(nodes, {"x": (1, 4)}, {"y": (1, 4)}, weights)
    return onnx, {"input_data": [x.reshape(-1).tolist()]}


def _conv2d_mnist_draws():
    """`examples/gen_graded.py`'s conv2d_mnist weights and input: the same
    draws of default_rng(7) in the same order."""
    rng = np.random.default_rng(7)
    d = {"k": rng.uniform(-0.3, 0.3, (4, 1, 5, 5)).astype(np.float32),
         "kb": rng.uniform(-0.1, 0.1, (4,)).astype(np.float32),
         "fcw": rng.uniform(-0.2, 0.2, (4 * 11 * 11, 10)).astype(np.float32),
         "fcb": rng.uniform(-0.1, 0.1, (10,)).astype(np.float32)}
    return d, (rng.integers(0, 256, (1, 1, 28, 28)) // 16).astype(np.float64)


def conv2d_mnist(writer):
    """`examples/gen_graded.py`'s conv2d_mnist with `writer` (an
    `onnx_writer`): (onnx bytes, input.json dict). Conv 4 x 1 x 5 x 5
    (stride 2) -> ReLU -> 2x2 average pool (stride 1) -> Flatten -> Gemm
    484 x 10 on a 1 x 1 x 28 x 28 input of pixels in [0, 16)."""
    weights, x = _conv2d_mnist_draws()
    nodes = [
        writer.node("Conv", ["x", "k", "kb"], ["c0"], name="conv",
                    kernel_shape=[5, 5], strides=[2, 2], pads=[0, 0, 0, 0]),
        writer.node("Relu", ["c0"], ["a0"], name="relu0"),
        writer.node("AveragePool", ["a0"], ["p0"], name="pool",
                    kernel_shape=[2, 2], strides=[1, 1]),
        writer.node("Flatten", ["p0"], ["f0"], name="flat"),
        writer.node("Gemm", ["f0", "fcw", "fcb"], ["y"], name="fc"),
    ]
    onnx = writer.model(nodes, {"x": (1, 1, 28, 28)}, {"y": (1, 10)}, weights)
    return onnx, {"input_data": [x.reshape(-1).tolist()]}


def conv2d_mnist_float():
    """The float64 forward of `conv2d_mnist` on its input, from its weights
    (the port's `forward_float` has no Conv): conv (stride 2, no padding) +
    bias, ReLU, 2x2 average pool of stride 1, flatten, x @ fcw + fcb."""
    w, x = _conv2d_mnist_draws()
    k, kb, fcw, fcb = (np.asarray(w[name], np.float64) for name in ("k", "kb", "fcw", "fcb"))
    x = x.reshape(28, 28)
    conv = np.empty((4, 12, 12))
    for i in range(12):
        for j in range(12):
            patch = x[2 * i:2 * i + 5, 2 * j:2 * j + 5]
            conv[:, i, j] = np.tensordot(k[:, 0], patch, axes=([1, 2], [0, 1])) + kb
    act = np.maximum(conv, 0.0)
    pool = (act[:, :-1, :-1] + act[:, 1:, :-1] + act[:, :-1, 1:] + act[:, 1:, 1:]) / 4.0
    return pool.reshape(-1) @ fcw + fcb


def with_logrows(settings_path, logrows, settings_cls):
    """Rewrite settings.json with `run_args.logrows` set, as the reference
    example's K = 20 sets it (`settings_cls`: a package's GraphSettings)."""
    path = pathlib.Path(settings_path)
    st = settings_cls.from_json(path.read_text())
    st.run_args.logrows = logrows
    path.write_text(st.to_json())
    return st


def _cli(*args):
    """`python -m ezkl_tpu_torch <args>` in a subprocess from the repo root
    (default device), with the seed of the API's proof."""
    env = dict(os.environ, EZKL_TPU_DET_SEED=str(SEED))
    out = subprocess.run([sys.executable, "-m", "ezkl_tpu_torch", *args],
                         cwd=str(pathlib.Path(__file__).resolve().parent), env=env,
                         capture_output=True, text=True, timeout=600)
    return out.returncode, (out.stdout + out.stderr).strip().splitlines()[-1:]


def graph(dev, wd):
    """Phase 6 in the directory `wd`. Returns (launches of the warm prove,
    launches of gen_srs)."""
    import torch
    from ezkl_tpu_torch import api
    from ezkl_tpu_torch.graph import onnx_writer
    from ezkl_tpu_torch.graph.model import forward_float
    from ezkl_tpu_torch.graph.run_args import RunArgs
    from ezkl_tpu_torch.kernels import build

    wd = pathlib.Path(wd)
    wd.mkdir(parents=True, exist_ok=True)
    f = {name: str(wd / name) for name in (
        "network.onnx", "input.json", "settings.json", "model.compiled", "kzg.srs",
        "witness.json", "vk.key", "pk.key", "proof.json", "proof_warm.json",
        "proof_bad.json", "proof_cli.json")}
    onnx, inp = mlp_4d(onnx_writer)
    pathlib.Path(f["network.onnx"]).write_bytes(onnx)
    pathlib.Path(f["input.json"]).write_text(json.dumps(inp))
    seconds = {}

    def phase(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return out

    st = phase("gen_settings", lambda: api.gen_settings(
        f["network.onnx"], f["settings.json"], RunArgs(logrows=GRAPH_LOGROWS)))
    k = st.run_args.logrows
    phase("compile", lambda: api.compile_circuit(f["network.onnx"], f["settings.json"],
                                                 f["model.compiled"]))
    build.reset_launches()
    phase("gen_srs", lambda: api.gen_srs(f["kzg.srs"], k, device=dev))
    srs_launches = dict(build.LAUNCHES)
    wit = phase("gen_witness", lambda: api.gen_witness(
        f["model.compiled"], f["input.json"], f["witness.json"], srs_path=f["kzg.srs"],
        device=dev))
    phase("setup", lambda: api.setup(f["model.compiled"], f["input.json"], f["kzg.srs"],
                                     f["vk.key"], f["pk.key"], device=dev))
    phase("prove_cold", lambda: api.prove(f["model.compiled"], f["input.json"], f["pk.key"],
                                          f["kzg.srs"], f["proof.json"], seed=SEED, device=dev))
    build.reset_launches()
    phase("prove_warm", lambda: api.prove(f["model.compiled"], f["input.json"], f["pk.key"],
                                          f["kzg.srs"], f["proof_warm.json"], seed=SEED,
                                          device=dev))
    launches = dict(build.LAUNCHES)
    ok = phase("verify", lambda: api.verify(f["proof.json"], f["vk.key"], f["kzg.srs"],
                                            device=dev))
    # tools/prove_graded.py's tamper: the first eval's low bit flipped
    pj = json.loads(pathlib.Path(f["proof.json"]).read_text())
    label = sorted(pj["evals"])[0]
    pj["evals"][label] = hex(int(pj["evals"][label], 16) ^ 1)
    pathlib.Path(f["proof_bad.json"]).write_text(json.dumps(pj))
    rejected = not api.verify(f["proof_bad.json"], f["vk.key"], f["kzg.srs"], device=dev)

    gc = api.load_compiled(f["model.compiled"])
    arrays = api._reshape_for(gc, api._load_input(f["input.json"], gc.model.input_scales()))
    want = np.concatenate([o.reshape(-1) for o in forward_float(gc.model, arrays)])
    got = np.concatenate([np.asarray(o).reshape(-1)
                          for o in wit["pretty_elements"]["rescaled_outputs"]])
    out_err = float(np.max(np.abs(got - want)))
    out_tol = 4.0 * 2.0 ** -st.run_args.input_scale
    # the lookup arguments per table: a table larger than the usable rows
    # splits into column sets, one argument each ("<table>#<j>")
    from ezkl_tpu_torch.plonk import serde
    names = [lk.name.split("#")[0] for lk in serde.load_vk(f["vk.key"]).cs.lookups]
    seeded = pathlib.Path(f["proof.json"]).read_bytes()
    warm_equal = pathlib.Path(f["proof_warm.json"]).read_bytes() == seeded

    t0 = time.perf_counter()
    cli_prove = _cli("prove", "--compiled-circuit", f["model.compiled"], "-D", f["input.json"],
                     "--pk-path", f["pk.key"], "--srs-path", f["kzg.srs"],
                     "--proof-path", f["proof_cli.json"])
    seconds["cli_prove"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli_verify = _cli("verify", "--proof-path", f["proof_cli.json"], "--vk-path", f["vk.key"],
                      "--srs-path", f["kzg.srs"])
    seconds["cli_verify"] = time.perf_counter() - t0
    cli_file = pathlib.Path(f["proof_cli.json"])
    cli_equal = cli_file.exists() and cli_file.read_bytes() == seeded
    emit({"phase": "graph", "model": GRAPH_MODEL, "k": k, "num_rows": st.num_rows,
          "lookups": st.required_lookups,
          "lookup_arguments": {name: names.count(name) for name in sorted(set(names))},
          "run_args": st.run_args.to_dict(), "seconds": seconds,
          "outputs": got.tolist(), "outputs_float": want.tolist(),
          "outputs_max_err": out_err, "outputs_tol": out_tol,
          "launches": launches, "gen_srs_launches": srs_launches,
          "verified": ok, "tamper_rejected": rejected, "warm_proof_equal": warm_equal,
          "cli_prove": cli_prove, "cli_verify": cli_verify, "cli_proof_equal": cli_equal})
    if not ok:
        raise AssertionError("the port's verifier rejected the mlp_4d proof")
    if not rejected:
        raise AssertionError("the verifier accepted the proof with a flipped eval")
    if not out_err <= out_tol:
        raise AssertionError(f"rescaled outputs {got} off the float forward {want} "
                             f"by {out_err} > {out_tol}")
    if not warm_equal:
        raise AssertionError("two seeded proofs of one witness differ")
    missing = [name for name in launches if name != "point_dbl" and launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the warm prove: {missing}")
    if srs_launches["point_dbl"] <= 0:
        raise AssertionError("point_dbl not launched by gen_srs")
    if not (cli_prove[0] == 0 and cli_verify[0] == 0 and cli_equal):
        raise AssertionError(f"the CLI's prove {cli_prove} / verify {cli_verify} failed or "
                             f"its proof differs from the API's (equal: {cli_equal})")
    return launches, srs_launches


# ---------------------------------------------------------------------------
# phase 8: the graded conv2d_mnist at k = 20, and aggregation with mlp_4d
# ---------------------------------------------------------------------------

CONV_MODEL = "conv2d_mnist"
# the outputs' largest error against the float64 forward, and the argmax
# equal (the CPU reading: 0.392, class 9)
CONV_TOL = 0.5


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in pathlib.Path(path).rglob("*") if p.is_file())


def conv(dev, wd, mlp):
    """Phase 8 in the directory `wd`: conv2d_mnist at k = 20 through the API,
    then the aggregate of its proof and mlp_4d's (`mlp`: the graph phase's
    (proof.json, vk.key) paths). Returns (launches of the warm prove,
    launches of gen_srs)."""
    import torch
    from ezkl_tpu_torch import api
    from ezkl_tpu_torch.graph import onnx_writer
    from ezkl_tpu_torch.graph.circuit import GraphSettings
    from ezkl_tpu_torch.kernels import build
    from ezkl_tpu_torch.plonk import prover, serde

    wd = pathlib.Path(wd)
    wd.mkdir(parents=True, exist_ok=True)
    f = {name: str(wd / name) for name in (
        "network.onnx", "input.json", "settings.json", "model.compiled", "kzg.srs",
        "witness.json", "vk.key", "pk.key", "proof.json", "proof_warm.json",
        "proof_bad.json", "proof_aggr.json", "proof_aggr_bad.json")}
    ckpt = wd / "checkpoints"
    onnx, inp = conv2d_mnist(onnx_writer)
    pathlib.Path(f["network.onnx"]).write_bytes(onnx)
    pathlib.Path(f["input.json"]).write_text(json.dumps(inp))
    seconds, peak = {}, {}

    def phase(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        # a prove resets the peak at each of its phases (`prover._span`)
        peaks = list(prover.PHASE_PEAK_BYTES.values()) if label.startswith("prove") else []
        peak[label] = max([torch.cuda.max_memory_allocated()] + peaks)
        return out

    st = phase("gen_settings", lambda: api.gen_settings(f["network.onnx"], f["settings.json"]))
    k_default = st.run_args.logrows
    # the reference example's K = 20
    st = with_logrows(f["settings.json"], K20, GraphSettings)
    phase("compile", lambda: api.compile_circuit(f["network.onnx"], f["settings.json"],
                                                 f["model.compiled"]))
    build.reset_launches()
    phase("gen_srs", lambda: api.gen_srs(f["kzg.srs"], K20, device=dev))
    srs_launches = dict(build.LAUNCHES)
    wit = phase("gen_witness", lambda: api.gen_witness(
        f["model.compiled"], f["input.json"], f["witness.json"], srs_path=f["kzg.srs"],
        device=dev))
    phase("setup", lambda: api.setup(f["model.compiled"], f["input.json"], f["kzg.srs"],
                                     f["vk.key"], f["pk.key"], device=dev))

    # the checkpoint's size, read as a successful prove clears it
    ckpt_bytes = {}
    real_clear = prover._ProveCheckpoint.clear

    def clear(self):
        ckpt_bytes.update({p.name: p.stat().st_size for p in self.dir.iterdir()})
        real_clear(self)

    prover._ProveCheckpoint.clear = clear
    try:
        prove_args = (f["model.compiled"], f["input.json"], f["pk.key"], f["kzg.srs"])
        phase("prove_cold", lambda: api.prove(*prove_args, f["proof.json"], seed=SEED,
                                              device=dev, checkpoint_dir=str(ckpt)))
        cold = (dict(prover.PHASE_SECONDS), dict(prover.PHASE_PEAK_BYTES))
        build.reset_launches()
        phase("prove_warm", lambda: api.prove(*prove_args, f["proof_warm.json"], seed=SEED,
                                              device=dev, checkpoint_dir=str(ckpt)))
        launches = dict(build.LAUNCHES)
        warm = (dict(prover.PHASE_SECONDS), dict(prover.PHASE_PEAK_BYTES))
    finally:
        prover._ProveCheckpoint.clear = real_clear
    ok = phase("verify", lambda: api.verify(f["proof.json"], f["vk.key"], f["kzg.srs"],
                                            device=dev))
    pj = json.loads(pathlib.Path(f["proof.json"]).read_text())
    label = sorted(pj["evals"])[0]
    pj["evals"][label] = hex(int(pj["evals"][label], 16) ^ 1)
    pathlib.Path(f["proof_bad.json"]).write_text(json.dumps(pj))
    rejected = not api.verify(f["proof_bad.json"], f["vk.key"], f["kzg.srs"], device=dev)
    warm_equal = (pathlib.Path(f["proof_warm.json"]).read_bytes()
                  == pathlib.Path(f["proof.json"]).read_bytes())

    want = conv2d_mnist_float()
    got = np.asarray(wit["pretty_elements"]["rescaled_outputs"], np.float64).reshape(-1)
    out_err = float(np.max(np.abs(got - want)))
    argmax_equal = int(np.argmax(got)) == int(np.argmax(want))

    # aggregate this proof with mlp_4d's: two circuits, two vks, one pairing
    proofs, vks = [str(mlp[0]), f["proof.json"]], [str(mlp[1]), f["vk.key"]]
    agg = phase("aggregate", lambda: api.aggregate(proofs, vks, f["proof_aggr.json"]))
    agg_ok = phase("verify_aggr", lambda: api.verify_aggr(f["proof_aggr.json"], vks,
                                                          f["kzg.srs"], device=dev))
    bad = json.loads(pathlib.Path(f["proof_aggr.json"]).read_text())
    label = sorted(bad["proofs"][1]["evals"])[0]
    bad["proofs"][1]["evals"][label] = hex(int(bad["proofs"][1]["evals"][label], 16) ^ 1)
    pathlib.Path(f["proof_aggr_bad.json"]).write_text(json.dumps(bad))
    agg_rejected = not api.verify_aggr(f["proof_aggr_bad.json"], vks, f["kzg.srs"],
                                       device=dev)

    vk = serde.load_vk(f["vk.key"])
    cs = vk.cs
    emit({"phase": "conv2d_mnist", "model": CONV_MODEL, "k_default_settings": k_default,
          "k": vk.k, "extended_k": vk.domain.extended_k, "num_rows": st.num_rows,
          "columns": {"fixed": cs.num_fixed, "advice": cs.num_advice,
                      "instance": cs.num_instance, "permutation": len(cs.perm_columns)},
          "lookup_arguments": len(cs.lookups), "gates": len(cs.gates),
          "max_gate_degree": cs.max_gate_degree(),
          "seconds": seconds, "peak_bytes": peak, "peak_bytes_all": max(peak.values()),
          "prove_cold_phases_s": cold[0], "prove_cold_phase_peak_bytes": cold[1],
          "prove_warm_phases_s": warm[0], "prove_warm_phase_peak_bytes": warm[1],
          "pk_key_bytes": os.path.getsize(f["pk.key"]),
          "srs_bytes": os.path.getsize(f["kzg.srs"]),
          "checkpoint_bytes": ckpt_bytes, "checkpoint_left": _dir_bytes(ckpt),
          "outputs": got.tolist(), "outputs_float": want.tolist(),
          "outputs_max_err": out_err, "outputs_tol": CONV_TOL,
          "argmax": int(np.argmax(got)), "argmax_float": int(np.argmax(want)),
          "launches": launches, "gen_srs_launches": srs_launches,
          "verified": ok, "tamper_rejected": rejected, "warm_proof_equal": warm_equal,
          "aggregate_proofs": agg["num_proofs"], "aggregate_verified": agg_ok,
          "aggregate_tamper_rejected": agg_rejected})
    if vk.k != K20 or vk.domain.extended_k != K20_EXT:
        raise AssertionError(f"conv2d_mnist at k = {vk.k}, extended {vk.domain.extended_k}")
    if not ok:
        raise AssertionError("the port's verifier rejected the conv2d_mnist proof")
    if not rejected:
        raise AssertionError("the verifier accepted the conv2d_mnist proof with a flipped eval")
    if not (out_err <= CONV_TOL and argmax_equal):
        raise AssertionError(f"outputs {got} off the float64 forward {want}: "
                             f"{out_err} > {CONV_TOL} or another argmax")
    if not warm_equal:
        raise AssertionError("two seeded conv2d_mnist proofs differ")
    if not (agg_ok and agg_rejected):
        raise AssertionError(f"aggregate verified {agg_ok}, tampered rejected {agg_rejected}")
    if max(peak.values()) >= 80e9:
        raise AssertionError(f"peak device memory {max(peak.values())} B")
    missing = [name for name in launches if name != "point_dbl" and launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the warm k = 20 prove: {missing}")
    if srs_launches["point_dbl"] <= 0:
        raise AssertionError("point_dbl not launched by gen_srs(20)")
    return launches, srs_launches


# ---------------------------------------------------------------------------
# phase 9: the EVM verifier -- conv2d_mnist at k = 20 through the API, and
# mlp_4d through the CLI
# ---------------------------------------------------------------------------

def _evm_rejects(api, proof_path, addr, chain) -> bool:
    """`verify_evm` on a proof it must not accept: False on a revert, a
    RuntimeError when the contract returns another word than 1."""
    try:
        return not api.verify_evm(proof_path, addr, chain)
    except RuntimeError:
        return True


def _bump_first_eval(src, dst):
    """Copy of a proof.json with its first eval (in sorted label order) + 1."""
    from ezkl_tpu_torch.fieldmath.spec import FR_MODULUS
    pj = json.loads(pathlib.Path(src).read_text())
    label = sorted(pj["evals"])[0]
    pj["evals"][label] = hex((int(pj["evals"][label], 16) + 1) % FR_MODULUS)
    pathlib.Path(dst).write_text(json.dumps(pj))


def _runtime_bytes(chain_path, addr_path) -> int:
    state = json.loads(pathlib.Path(chain_path).read_text())
    return len(bytes.fromhex(state["code"][pathlib.Path(addr_path).read_text().strip()]))


def evm(dev, conv_dir, graph_dir):
    """Phase 9 in the conv and graph phases' directories. (a) conv2d_mnist at
    k = 20: the EVM verifier takes no multi-phase circuit, in either package
    ("disable_freivalds=True"), and conv2d_mnist's default run arguments
    check its Gemm by Freivalds (one challenge), so the phase keys it again
    with `RunArgs(disable_freivalds=True)` (its settings settle on k = 16),
    at k = 20 on the conv phase's SRS; then an EVM-transcript proof made on
    the card, create_evm_verifier, deploy_evm and verify_evm (True); the
    copy with its first eval + 1 and the conv phase's default-transcript
    proof rejected. (b) mlp_4d on the graph phase's key (one phase): an
    EVM-transcript proof on the card, then the CLI's create-evm-verifier,
    deploy-evm, verify-evm (exit 0) and encode-evm-calldata (bytes equal to
    the API's); the tampered proof and the graph phase's default-transcript
    proof of the same circuit give verify-evm exit 1, and calldata one byte
    short reverts on the port's EVM. Launch counts are reset just before
    each EVM prove and read just after. Returns the two proves' launches."""
    import torch
    from ezkl_tpu_torch import api
    from ezkl_tpu_torch.evm import vm
    from ezkl_tpu_torch.graph.circuit import GraphSettings
    from ezkl_tpu_torch.graph.run_args import RunArgs
    from ezkl_tpu_torch.kernels import build
    from ezkl_tpu_torch.plonk import prover

    out, launches = {}, {}
    for name, src in (("conv2d_mnist", pathlib.Path(conv_dir)),
                      ("mlp_4d", pathlib.Path(graph_dir))):
        wd = src / "evm"
        wd.mkdir()
        f = {n: str(wd / n) for n in ("proof.json", "proof_bad.json", "Verifier.sol",
                                       "Verifier.bin", "contract.addr", "evm_chain.json",
                                       "calldata.bin", "settings.json")}
        seconds, row = {}, {}

        def step(label, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
            return r

        keys = src
        if name == "conv2d_mnist":
            keys = wd
            st = step("gen_settings", lambda: api.gen_settings(
                str(src / "network.onnx"), f["settings.json"], RunArgs(disable_freivalds=True)))
            row["k_default_settings"] = st.run_args.logrows
            st = with_logrows(f["settings.json"], K20, GraphSettings)
            row["num_rows"] = st.num_rows
            step("compile", lambda: api.compile_circuit(str(src / "network.onnx"),
                                                        f["settings.json"],
                                                        str(wd / "model.compiled")))
            step("setup", lambda: api.setup(str(wd / "model.compiled"), str(src / "input.json"),
                                            str(src / "kzg.srs"), str(wd / "vk.key"),
                                            str(wd / "pk.key"), device=dev))
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        step("prove", lambda: api.prove(str(keys / "model.compiled"), str(src / "input.json"),
                                        str(keys / "pk.key"), str(src / "kzg.srs"),
                                        f["proof.json"], transcript="evm", seed=SEED,
                                        device=dev))
        launches[name] = dict(build.LAUNCHES)
        peak = max([torch.cuda.max_memory_allocated()] + list(prover.PHASE_PEAK_BYTES.values()))
        host_ok = step("verify_host", lambda: api.verify(
            f["proof.json"], str(keys / "vk.key"), str(src / "kzg.srs"), transcript="evm",
            device=dev))
        _bump_first_eval(f["proof.json"], f["proof_bad.json"])
        calldata = api.encode_evm_calldata(f["proof.json"], output=None)
        row.update(seconds=seconds, prove_peak_bytes=peak, launches=launches[name],
                   host_verified_evm_transcript=host_ok, calldata_bytes=len(calldata))
        if name == "conv2d_mnist":
            step("create_evm_verifier", lambda: api.create_evm_verifier(
                str(keys / "vk.key"), str(src / "kzg.srs"), f["Verifier.sol"], device=dev))
            step("deploy_evm", lambda: api.deploy_evm(f["Verifier.bin"], f["contract.addr"],
                                                      f["evm_chain.json"]))
            ok = step("verify_evm", lambda: api.verify_evm(f["proof.json"], f["contract.addr"],
                                                           f["evm_chain.json"]))
            row.update(
                verified=ok,
                tamper_rejected=_evm_rejects(api, f["proof_bad.json"], f["contract.addr"],
                                             f["evm_chain.json"]),
                default_transcript_rejected=_evm_rejects(
                    api, str(src / "proof.json"), f["contract.addr"], f["evm_chain.json"]))
        else:
            chain = ("--addr-path", f["contract.addr"], "--chain-path", f["evm_chain.json"])
            cli = {}
            for label, args in (
                    ("create-evm-verifier", ("--vk-path", str(src / "vk.key"), "--srs-path",
                                             str(src / "kzg.srs"), "--sol-code-path",
                                             f["Verifier.sol"])),
                    ("deploy-evm", ("--bin-path", f["Verifier.bin"]) + chain),
                    ("verify-evm", ("--proof-path", f["proof.json"]) + chain),
                    ("encode-evm-calldata", ("--proof-path", f["proof.json"], "-O",
                                             f["calldata.bin"]))):
                t0 = time.perf_counter()
                cli[label] = _cli(label, *args)
                seconds[f"cli_{label}"] = time.perf_counter() - t0
            cli["verify-evm tampered"] = _cli("verify-evm", "--proof-path", f["proof_bad.json"],
                                              *chain)
            cli["verify-evm default transcript"] = _cli(
                "verify-evm", "--proof-path", str(src / "proof.json"), *chain)
            E = api._load_chain(vm, f["evm_chain.json"])
            addr = int(pathlib.Path(f["contract.addr"]).read_text().strip(), 16)
            try:
                E.call(addr, calldata[:-1])
                short_reverts = False
            except vm.EvmRevert:
                short_reverts = True
            calldata_file = pathlib.Path(f["calldata.bin"])
            row.update(
                cli={k: v[0] for k, v in cli.items()}, cli_last_lines=cli,
                verified=cli["verify-evm"][0] == 0,
                tamper_rejected=cli["verify-evm tampered"][0] == 1,
                default_transcript_rejected=cli["verify-evm default transcript"][0] == 1,
                cli_calldata_equal=calldata_file.exists()
                and calldata_file.read_bytes() == calldata,
                short_calldata_reverts=short_reverts)
        from ezkl_tpu_torch.plonk import serde
        row["k"] = serde.load_vk(str(keys / "vk.key")).k
        row["runtime_bytes"] = _runtime_bytes(f["evm_chain.json"], f["contract.addr"])
        row["initcode_bytes"] = os.path.getsize(f["Verifier.bin"])
        row["solidity_bytes"] = os.path.getsize(f["Verifier.sol"])
        out[name] = row
    emit({"phase": "evm", **out})
    for name, row in out.items():
        bad = [key for key in ("verified", "tamper_rejected", "host_verified_evm_transcript",
                               "default_transcript_rejected", "cli_calldata_equal",
                               "short_calldata_reverts") if key in row and not row[key]]
        if bad:
            raise AssertionError(f"evm phase, {name}: {bad} failed")
        if name == "conv2d_mnist" and row["k"] != K20:
            raise AssertionError(f"evm phase: conv2d_mnist keyed at k = {row['k']}")
        if name == "mlp_4d" and any(v != 0 for k, v in row["cli"].items()
                                    if not k.startswith("verify-evm ")):
            raise AssertionError(f"evm phase: a CLI subcommand failed: {row['cli_last_lines']}")
        missing = [k for k in row["launches"] if k != "point_dbl" and row["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched by the {name} EVM prove: {missing}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the mesh -- four shards on the card against the single-device path
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_MSM_K = 20
MESH_NTT_COLUMNS = 8


def mesh(dev, rng, stand_in, srs_path=None):
    """Phase 10: `make_mesh(devices=[dev] * 4)`, four shards standing in for
    four cards (and, where the machine has two cards or more, a mesh of up to
    four distinct cards too), each check against the single-device path:
    `msm_sharded` of the first 2^20 points of the k = 20 SRS (`srs_path`,
    the conv phase's; made by gen_srs(20) when None) with seeded scalars,
    affine-equal to `msm.msm_multi`; `ntt_sharded_batched` of 8 x 2^23,
    forward and inverse, word-equal to `ntt.ntt` / `ntt.intt`;
    `to_ext_sharded` of 8 columns of 2^20, word-equal to
    `coeff_to_extended(intt(.))`; and the k = 14 stand-in's seeded proof
    with the mesh set (`stand_in`: (srs, pk, asg, the proof's JSON without
    a mesh)), byte-equal to the proof without it and verified. Launch counts
    are reset just before that prove and read just after. Returns them."""
    import torch
    from ezkl_tpu_torch.fieldmath import curve, limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr
    from ezkl_tpu_torch.kernels import build, msm, ntt
    from ezkl_tpu_torch.parallel import sharded
    from ezkl_tpu_torch.plonk import prover, srs as srsmod, verifier
    from ezkl_tpu_torch.plonk.domain import domain

    FR = bn254_fr()
    srs_k14, pk, asg, baseline = stand_in
    meshes = {f"stand-in: {MESH_SHARDS} shards on {dev}": sharded.make_mesh(
        devices=[dev] * MESH_SHARDS)}
    count = torch.cuda.device_count()
    if count >= 2:
        meshes[f"{min(count, MESH_SHARDS)} distinct cards"] = sharded.make_mesh(
            min(count, MESH_SHARDS))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))

    def field(*shape, mont=True):
        v = torch.randint(0, 1 << 31, (8,) + shape, generator=gen, device=dev,
                          dtype=torch.int64)
        v[7] &= 0x0FFFFFFF                               # below the modulus
        v = v.to(torch.int32)
        return limbs.to_mont(FR, v) if mont else v

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    n = 1 << MESH_MSM_K
    if srs_path is not None:
        srs20 = srsmod.load(srs_path, dev)
    else:
        srs20 = srsmod.gen_srs(MESH_MSM_K, device=dev)
    pts = srs20.g1.map(lambda a: a[:, :n].contiguous())
    del srs20
    scalars = field(n, mont=False)
    ext_k = K20_EXT
    x = field(MESH_NTT_COLUMNS, 1 << ext_k)
    dom = domain(MESH_MSM_K, extended_k=ext_k)
    cols = field(MESH_NTT_COLUMNS, n).movedim(1, 0).contiguous()     # (8 columns, 8, 2^20)

    single = {}
    want_msm, single["msm_s"] = timed(lambda: msm.msm_multi(pts, scalars[None], affine=True))
    want_msm = curve.decode_points(want_msm)[0]
    want_fwd, single["ntt_s"] = timed(lambda: ntt.ntt(FR, x))
    want_inv, single["intt_s"] = timed(lambda: ntt.intt(FR, want_fwd))
    inverse_round_trip = torch.equal(want_inv, x)
    del want_inv
    want_ext, single["to_ext_s"] = timed(
        lambda: dom.coeff_to_extended(ntt.intt(FR, cols.movedim(1, 0))).movedim(1, 0))
    _, single["prove_s"] = timed(lambda: prover.create_proof(pk, srs_k14, asg, seed=SEED))

    rows, mesh_launches = {}, None
    for label, m in meshes.items():
        r = {"devices": [str(d) for d in m]}
        got, r["msm_s"] = timed(lambda: sharded.msm_sharded(m, pts, scalars, affine=True))
        r["msm_equal"] = curve.decode_points(got.map(lambda a: a[:, None]))[0] == want_msm
        got, r["ntt_s"] = timed(lambda: sharded.ntt_sharded_batched(m, FR, x))
        r["ntt_equal"] = torch.equal(got, want_fwd)
        got, r["intt_s"] = timed(lambda: sharded.ntt_sharded_batched(m, FR, want_fwd,
                                                                     inverse=True))
        r["intt_equal"] = torch.equal(got, x)
        del got
        got, r["to_ext_s"] = timed(lambda: sharded.to_ext_sharded(m, dom, cols))
        r["to_ext_equal"] = torch.equal(got, want_ext)
        del got
        torch.cuda.empty_cache()
        sharded.set_mesh(m)
        build.reset_launches()
        try:
            proof, r["prove_s"] = timed(lambda: prover.create_proof(pk, srs_k14, asg, seed=SEED))
        finally:
            sharded.set_mesh(None)
        r["launches"] = dict(build.LAUNCHES)
        if mesh_launches is None:
            mesh_launches = r["launches"]
        r["proof_equal"] = proof.to_json() == baseline
        r["proof_verified"] = verifier.verify(pk.vk, srs_k14.g2, srs_k14.s_g2, proof)
        rows[label] = r
    emit({"phase": "mesh", "shards": MESH_SHARDS, "cards": count, "msm_points": n,
          "ntt": f"{MESH_NTT_COLUMNS} x 2^{ext_k}",
          "to_ext": f"{MESH_NTT_COLUMNS} x 2^{MESH_MSM_K} -> 2^{ext_k}", "prove_k": K,
          "single_device": single, "single_inverse_round_trip": inverse_round_trip,
          "meshes": rows})
    for label, r in rows.items():
        bad = [k for k in ("msm_equal", "ntt_equal", "intt_equal", "to_ext_equal",
                           "proof_equal", "proof_verified") if not r[k]]
        if bad or not inverse_round_trip:
            raise AssertionError(f"mesh phase, {label}: {bad} differ from one device")
        missing = [k for k in r["launches"] if k != "point_dbl" and r["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched by the mesh prove: {missing}")
    return mesh_launches


# ---------------------------------------------------------------------------
# phase 11: families -- recurrent, attention, dynamic-gather and committed-I/O
# circuits through the file API
# ---------------------------------------------------------------------------

# the card's widths (`tests/torch_port_graph_models.py` CARD_MODELS): the k
# the settings must settle on, and the largest error of the rescaled outputs
# against the float64 forward (the LSTM: `tests/test_recurrent.py`'s bound
# at the same scale 7)
FAMILY_CARD = {"lstm_bidi_h32": (17, 0.15), "attn_s32_d64": (18, 0.25)}
# the small models proved on the card; those with frozen JAX-package proofs
# must reproduce vk.key and proof.json byte for byte
FAMILY_SMALL = ("lstm_bidi", "attn_small", "gather_dyn", "bmm_einsum", "mlp_4d_kzg_io")
SPLIT_PARTS = ("mlp_4d_split_0", "mlp_4d_split_1")


def graph_models():
    """`tests/torch_port_graph_models.py`, the models' constructors and their
    float64 forwards (numpy only)."""
    tests = str(pathlib.Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_port_graph_models
    return torch_port_graph_models


def _tamper(src, dst):
    """The proof with its first instance plus one; one without instances
    (committed inputs and outputs) gets its first eval's low bit flipped."""
    pj = json.loads(pathlib.Path(src).read_text())
    cells = [(i, j) for i, col in enumerate(pj["instances"]) for j in range(len(col))]
    if cells:
        i, j = cells[0]
        pj["instances"][i][j] = hex(int(pj["instances"][i][j], 16) + 1)
    else:
        label = sorted(pj["evals"])[0]
        pj["evals"][label] = hex(int(pj["evals"][label], 16) ^ 1)
    pathlib.Path(dst).write_text(json.dumps(pj))
    return "instance" if cells else "eval"


def _device_busy(fn):
    """(wall seconds, device busy seconds) of `fn()` under torch.profiler:
    the summed durations of the card's kernels and copies."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    return wall, busy / 1e9


def family_pipeline(dev, models, name, wd, witness_dir=None, warm=True, profile=False):
    """One model of `torch_port_graph_models` through the API on the card in
    `wd`: gen_settings, compile, gen_srs, gen_witness, setup, prove(seed=1)
    (cold, and with `warm` again), verify, and the tampered proof rejected;
    with `profile` one more prove under torch.profiler for the device's busy
    time. Seconds, peak device bytes and K1-K9 launches per step. Returns
    (row, witness)."""
    import torch
    from ezkl_tpu_torch import api
    from ezkl_tpu_torch.graph import onnx_writer
    from ezkl_tpu_torch.graph.run_args import RunArgs
    from ezkl_tpu_torch.kernels import build
    from ezkl_tpu_torch.plonk import prover, serde

    wd = pathlib.Path(wd)
    wd.mkdir(parents=True, exist_ok=True)
    f = {p: str(wd / p) for p in (
        "network.onnx", "input.json", "settings.json", "model.compiled", "kzg.srs",
        "witness.json", "vk.key", "pk.key", "proof.json", "proof_warm.json",
        "proof_prof.json", "proof_bad.json")}
    onnx, inp = models.build(name, onnx_writer, witness_dir)
    pathlib.Path(f["network.onnx"]).write_bytes(onnx)
    pathlib.Path(f["input.json"]).write_text(json.dumps(inp))
    seconds, peak, launches, phases = {}, {}, {}, {}

    def step(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        peaks = list(prover.PHASE_PEAK_BYTES.values()) if label.startswith("prove") else []
        peak[label] = max([torch.cuda.max_memory_allocated()] + peaks)
        launches[label] = {k: v for k, v in build.LAUNCHES.items() if v}
        if label.startswith("prove"):
            phases[label] = {"seconds": dict(prover.PHASE_SECONDS),
                             "peak_bytes": dict(prover.PHASE_PEAK_BYTES)}
        return out

    st = step("gen_settings", lambda: api.gen_settings(
        f["network.onnx"], f["settings.json"], models.run_args(RunArgs, name)))
    k = st.run_args.logrows
    step("compile", lambda: api.compile_circuit(f["network.onnx"], f["settings.json"],
                                                f["model.compiled"]))
    step("gen_srs", lambda: api.gen_srs(f["kzg.srs"], k, device=dev))
    wit = step("gen_witness", lambda: api.gen_witness(
        f["model.compiled"], f["input.json"], f["witness.json"], srs_path=f["kzg.srs"],
        device=dev))
    step("setup", lambda: api.setup(f["model.compiled"], f["input.json"], f["kzg.srs"],
                                    f["vk.key"], f["pk.key"], device=dev))
    prove_args = (f["model.compiled"], f["input.json"], f["pk.key"], f["kzg.srs"])
    step("prove_cold", lambda: api.prove(*prove_args, f["proof.json"], seed=SEED, device=dev))
    if warm:
        step("prove_warm", lambda: api.prove(*prove_args, f["proof_warm.json"], seed=SEED,
                                             device=dev))
    busy = None
    if profile:
        wall, busy_s = _device_busy(lambda: api.prove(*prove_args, f["proof_prof.json"],
                                                      seed=SEED, device=dev))
        busy = {"profiled_wall_s": wall, "device_busy_s": busy_s, "busy_share": busy_s / wall}
    ok = step("verify", lambda: api.verify(f["proof.json"], f["vk.key"], f["kzg.srs"],
                                           device=dev))
    tamper = _tamper(f["proof.json"], f["proof_bad.json"])
    rejected = not api.verify(f["proof_bad.json"], f["vk.key"], f["kzg.srs"], device=dev)
    seeded = pathlib.Path(f["proof.json"]).read_bytes()
    cs = serde.load_vk(f["vk.key"]).cs
    row = {"model": name, "k": k, "num_rows": st.num_rows,
           "lookups": st.required_lookups, "lookup_arguments": len(cs.lookups),
           "columns": {"fixed": cs.num_fixed, "advice": cs.num_advice,
                       "instance": cs.num_instance},
           "challenges": cs.num_challenges, "seconds": seconds, "peak_bytes": peak,
           "prove_phases": phases, "launches": launches, "busy": busy,
           "verified": ok, "tamper": tamper, "tamper_rejected": rejected,
           "warm_proof_equal": (pathlib.Path(f["proof_warm.json"]).read_bytes() == seeded
                                if warm else None)}
    fx = models.FIXTURES / f"graph_{name}"
    if (fx / "proof.json").exists():
        row["fixture_equal"] = {p: pathlib.Path(f[p]).read_bytes() == (fx / p).read_bytes()
                                for p in ("settings.json", "model.compiled", "witness.json",
                                          "vk.key", "proof.json")}
    return row, wit


def _check_family(row):
    """The checks every family pipeline must pass; K1-K8 launched by the
    last prove, K9 by gen_srs."""
    name = row["model"]
    if not (row["verified"] and row["tamper_rejected"]
            and row["warm_proof_equal"] in (True, None)):
        raise AssertionError(f"{name}: verified {row['verified']}, tampered proof rejected "
                             f"{row['tamper_rejected']}, warm proof equal "
                             f"{row['warm_proof_equal']}")
    if not all(row.get("fixture_equal", {}).values()):
        raise AssertionError(f"{name}: files differ from the JAX package's frozen ones: "
                             f"{row['fixture_equal']}")
    missing = [k for k in KERNEL_META if k != "point_dbl"
               and _last_prove(row).get(k, 0) <= 0]
    if missing or row["launches"]["gen_srs"].get("point_dbl", 0) <= 0:
        raise AssertionError(f"{name}: kernels not launched: {missing}, gen_srs K9 "
                             f"{row['launches']['gen_srs'].get('point_dbl', 0)}")


def _last_prove(row):
    """Launches of the pipeline's last (warm, else cold) prove."""
    return row["launches"].get("prove_warm", row["launches"]["prove_cold"])


def _rescaled_outputs(wit):
    return np.concatenate([np.asarray(o, np.float64).reshape(-1)
                           for o in wit["pretty_elements"]["rescaled_outputs"]])


def families(dev, wd, once=False):
    """Phase 11 in the directory `wd`: the card widths of the LSTM and the
    attention block (`FAMILY_CARD`; a warm and a profiled prove after the
    cold one, or with `once` the cold prove alone; outputs against the
    float64 forward), the small models of `FAMILY_SMALL`, and the split flow
    (both mlp_4d parts, the boundary commitments equal, a doctored
    commitment swapped in refused and its proof rejected, the aggregate of
    the two part proofs accepted by `verify_aggr` and rejected with an inner
    eval flipped). One `families` line per model and one for the split.
    Returns {model: launches of its last prove, K9 from its gen_srs}."""
    from ezkl_tpu_torch import api
    from ezkl_tpu_torch.fieldmath import hostcurve

    models = graph_models()
    wd = pathlib.Path(wd)
    out = {}

    def record(row):
        emit({"phase": "families", **row})
        _check_family(row)
        out[row["model"]] = dict(_last_prove(row),
                                 point_dbl=row["launches"]["gen_srs"].get("point_dbl", 0))

    for name, (k, tol) in FAMILY_CARD.items():
        row, wit = family_pipeline(dev, models, name, wd / name, warm=not once,
                                   profile=not once)
        got, want = _rescaled_outputs(wit), models.FLOAT_FORWARDS[name]().reshape(-1)
        row.update(outputs_max_err=float(np.max(np.abs(got - want))), outputs_tol=tol,
                   outputs_mean_err=float(np.mean(np.abs(got - want))))
        if row["k"] != k:
            emit({"phase": "families", **row})
            raise AssertionError(f"{name} settled on k = {row['k']}, not {k}")
        if not (got.shape == want.shape and row["outputs_max_err"] <= tol):
            emit({"phase": "families", **row})
            raise AssertionError(f"{name}: outputs off the float64 forward by "
                                 f"{row['outputs_max_err']} > {tol}")
        record(row)
    for name in FAMILY_SMALL:
        record(family_pipeline(dev, models, name, wd / name)[0])

    # the split flow: part 1's input is part 0's rescaled output on the card
    rows, wits = [], []
    for name in SPLIT_PARTS:
        row, wit = family_pipeline(dev, models, name, wd / name, witness_dir=lambda o: wd / o)
        rows.append(row)
        wits.append(wit)
    for row in rows:
        record(row)
    pc = [w["processed_commitments"] for w in wits]
    linked = pc[0]["polycommit"] == pc[1]["polycommit"] and len(pc[0]["polycommit"]) == 1
    d = [wd / name for name in SPLIT_PARTS]
    carried = all(
        [[int(v, 16) for v in json.loads((di / "proof.json").read_text())["advice"][i]]
         for i in p["advice_indices"]] ==
        [[int(v, 16) for v in c] for c in p["polycommit"]] for di, p in zip(d, pc))
    x, y = hostcurve.g1_mul(hostcurve.G1, 7)
    doctored = json.loads(json.dumps(wits[0]))
    doctored["processed_commitments"]["polycommit"][0] = [hex(x), hex(y)]
    (wd / "witness_doctored.json").write_text(json.dumps(doctored))
    swapped = wd / "proof_swapped.json"
    swapped.write_bytes((d[0] / "proof.json").read_bytes())
    swap_refused = not api.swap_proof_commitments(swapped, wd / "witness_doctored.json")
    swap_rejected = not api.verify(swapped, d[0] / "vk.key", d[0] / "kzg.srs", device=dev)
    proofs = [str(di / "proof.json") for di in d]
    vks = [str(di / "vk.key") for di in d]
    t0 = time.perf_counter()
    agg = api.aggregate(proofs, vks, str(wd / "proof_aggr.json"))
    agg_ok = api.verify_aggr(str(wd / "proof_aggr.json"), vks, d[0] / "kzg.srs", device=dev)
    agg_s = time.perf_counter() - t0
    bad = json.loads((wd / "proof_aggr.json").read_text())
    label = sorted(bad["proofs"][1]["evals"])[0]
    bad["proofs"][1]["evals"][label] = hex(int(bad["proofs"][1]["evals"][label], 16) ^ 1)
    (wd / "proof_aggr_bad.json").write_text(json.dumps(bad))
    agg_rejected = not api.verify_aggr(str(wd / "proof_aggr_bad.json"), vks,
                                       d[0] / "kzg.srs", device=dev)
    emit({"phase": "families", "model": "mlp_4d_split", "linked": linked,
          "commitments_in_proofs": carried, "doctored_swap_refused": swap_refused,
          "doctored_proof_rejected": swap_rejected, "aggregate_proofs": agg["num_proofs"],
          "aggregate_verified": agg_ok, "aggregate_tamper_rejected": agg_rejected,
          "aggregate_and_verify_s": agg_s})
    if not (linked and carried and swap_refused and swap_rejected and agg_ok
            and agg_rejected):
        raise AssertionError("the split flow failed its checks")
    return out


# ---------------------------------------------------------------------------
# phase 4, continued: crash and resume the k = 14 prove
# ---------------------------------------------------------------------------

RESUME_CUTS = ("phase5: quotient", "phase6: evaluations")


def resume(dev, pk, srs, asg, baseline, wd):
    """The stand-in's seed-1 prove with a checkpoint directory, crashed by
    `prover._span` raising as a phase starts (after the "cols" cut point,
    then after the "h" one), then run again: the resumed proof must equal
    the uninterrupted one byte for byte, and the checkpoint must clear."""
    from ezkl_tpu_torch.plonk import prover

    out = {}
    for i, cut in enumerate(RESUME_CUTS):
        root = pathlib.Path(wd) / f"resume{i}"
        real = prover._span

        def boom(msg, device=None, cut=cut):
            if msg == cut:
                raise RuntimeError(f"injected crash at {msg}")
            real(msg, device)

        prover._span = boom
        crashed = False
        try:
            prover.create_proof(pk, srs, asg, seed=SEED, checkpoint_dir=str(root))
        except RuntimeError:
            crashed = True
        finally:
            prover._span = real
        saved = sorted(p.name for p in root.glob("prove-*/*.npz"))
        t0 = time.perf_counter()
        proof = prover.create_proof(pk, srs, asg, seed=SEED, checkpoint_dir=str(root))
        out[cut] = dict(crashed=crashed, saved=saved, resume_s=time.perf_counter() - t0,
                        resumed_phases=sorted(k for k in prover.PHASE_SECONDS if "resumed" in k),
                        equal=proof.to_json() == baseline,
                        cleared=not list(root.glob("prove-*/*")))
    emit({"phase": "resume", "k": K, "cuts": out})
    for cut, r in out.items():
        if not (r["crashed"] and r["saved"] and r["resumed_phases"] and r["equal"]
                and r["cleared"]):
            raise AssertionError(f"crash at {cut!r} and resume failed: {r}")


# ---------------------------------------------------------------------------
# phase 3, continued: the kernels at the k = 20 path's widths
# ---------------------------------------------------------------------------

# conv2d_mnist at k = 20: commitments are fused MSMs of 2^20 points at c = 16
# (W = 16 signed windows, B = 2^15 buckets) in window groups of 8 windows
# (`msm.window_group`: 2^23 point-windows); the quotient's transforms run on
# groups of 8 columns of the 2^23-point extended coset
# (`prover.EXT_GROUP_ELEMENTS`); `gen_srs(20)` doubles 2^20 lanes.
K20 = 20
K20_EXT = 23
K20_COLUMNS = 32                 # the widest commitment: 31 fixed columns padded to 32


def check_k20_widths(dev, rng):
    """K1-K9 at the widths the k = 20 path launches them. Each kernel runs
    on the whole input; its plain version runs on the first and last lanes
    (rows, groups, columns) of the same inputs, which the kernel computes
    independently, and must agree bit for bit: an index or grid fault past
    2^31 words or 2^16 blocks shows at the far end. Device ms (operands
    from HBM) beside the bound of the whole launch. Returns name -> row."""
    import torch
    from ezkl_tpu_torch.fieldmath import curve, limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr, bn254_fq
    from ezkl_tpu_torch.kernels import msm, ntt, pcurve, pntt
    from ezkl_tpu_torch.plonk import prover

    FR, FQ = bn254_fr(), bn254_fq()
    mm = IMAD_PER_MONT_MUL
    n = 1 << K20
    c = msm.default_window_bits(n)
    W = len(msm._signed_windows(c))
    G = msm.window_group(K20_COLUMNS, W, n)
    S, B = MSM_S, 1 << (c - 1)
    lanes = G * n // S
    P, (ax, ay) = _pool(dev, rng)
    zero = torch.zeros(8, dtype=torch.int32, device=dev)
    ident = (zero, limbs.const(FQ, 1, device=dev), zero)
    rows = {}

    def rand_idx(*shape):
        return torch_index(rng.integers(0, P.x.shape[1], size=shape), dev)

    def points(*shape):
        mask = torch_index(rng.random(shape) < 0.05, dev).bool()
        mask.view(-1)[0] = mask.view(-1)[-1] = True
        return list(_set(_gather(P, rand_idx(*shape)), mask, ident))

    def ends(dim, m):
        """The first and last m entries along `dim`."""
        def pick(t):
            size = t.shape[dim]
            lo = min(m, size)
            idx = torch.cat([torch.arange(lo), torch.arange(max(size - m, lo), size)])
            return t.index_select(dim, idx.to(t.device))
        return pick

    def line(name, kern, plain, inputs, pick_in, pick_out, checked, nbytes, imad, reps,
             **shape):
        got = [pick_out(t) for t in _outputs(kern(*inputs))]
        want = _outputs(plain(*[pick_in(t) for t in inputs]))
        err = max_abs_err(got, want)
        r = dict(path="conv2d_mnist k=20", max_abs_err=err, checked=checked, **shape,
                 ms=device_ms(kern, inputs, reps=reps))
        r["bound_ms"], r["bound_by"] = bound(nbytes, imad)
        emit({"phase": "kernel", "kernel": name, **r})
        if err:
            raise AssertionError(f"{name} kernel != plain at the k = 20 width ({shape})")
        rows[name] = r
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))

    def field(count):
        """count random Fr elements, Montgomery, made on the card."""
        v = torch.randint(0, 1 << 31, (8, count), generator=gen, device=dev, dtype=torch.int64)
        v[7] &= 0x0FFFFFFF                               # below the modulus
        return limbs.to_mont(FR, v.to(torch.int32))

    ext = 1 << K20_EXT
    # K1: the quotient's products over one column of the extended coset
    a, b = field(ext), field(ext)
    line("mont_mul", lambda x, y: limbs._mont_mul_kernel(FR, x, y),
         lambda x, y: limbs.mont_mul_plain(FR, x, y), [a, b], ends(-1, 4096), ends(-1, 4096),
         "elements: first and last 4096",
         3 * 32 * ext, mm * ext, 5, field=FR.name, n=ext, b="dense")
    del a, b
    # K1's scan: the 32-step blocks of a 2^20-element prefix product
    # (`batch_inv` of a column), 2^15 rows
    v = field(n).reshape(8, n // 32, 32)
    line("mont_scan", lambda x: limbs._mont_scan_kernel(FR, x),
         lambda x: limbs.seq_scan_mul_plain(FR, x), [v], ends(1, 256), ends(1, 256),
         "rows: first and last 256", 64 * n,
         31 * mm * (n // 32), 5, field=FR.name, rows=n // 32, steps=32)
    del v
    # K1's power: a Fermat inversion of one element, as at k = 14
    e = FR.modulus - 2
    products = limbs.pow_schedule(e)[3]
    line("mont_pow", lambda x: limbs._mont_pow_kernel(FR, x, e),
         lambda x: limbs.pow_static_plain(FR, x, e), [field(1)], ends(-1, 1), ends(-1, 1),
         "all", 64,
         products * mm, 20, field=FR.name, n=1, exponent="p-2")
    # K2: one transform group of the quotient, 8 columns of 2^23 (3 passes);
    # the plain version on the last column
    cols = max(1, prover.EXT_GROUP_ELEMENTS // ext)
    tw = ntt.twiddles(FR, K20_EXT, False, dev)
    split = pntt.pass_split(K20_EXT)
    x = field(cols * ext).reshape(8, cols, ext)

    def passes(y, run):
        for s0, r in split:
            y = run(FR, y, tw, K20_EXT, s0, r)
        return y
    line("ntt_stages", lambda y: passes(y, pntt._stages_kernel),
         lambda y: passes(y, pntt.stages_plain), [x], lambda t: t[:, -1:],
         lambda t: t[:, -1:], "columns: the last", len(split) * 2 * 32 * cols * ext,
         K20_EXT * (ext // 2) * cols * mm, 2,
         field=FR.name, columns=cols, k=K20_EXT, passes=len(split), whole_ntt=True)
    del x
    # K4: one window group's packed scan, G windows of 2^20 points
    x, y = _gather((ax, ay), rand_idx(S, lanes))
    sn = torch_index(rng.integers(0, 2, size=(S, lanes)), dev).to(torch.int32)
    line("scan_packed", pcurve._scan_packed_kernel, pcurve.scan_packed_plain, [x, y, sn],
         ends(-1, 64), ends(-1, 64), "lanes: first and last 64",
         (2 * 32 + 4 + 96) * S * lanes, 11 * mm * (S - 1) * lanes, 3,
         windows=G, points=n, lanes=lanes, steps=S, team=pcurve.lane_team(lanes))
    del x, y, sn
    # K5: the block-total prefix of one group, G x 2^13 totals as 2^9 lanes
    # of 128 steps
    L5 = G * (n // S) // S
    Pq = points(S, L5)
    line("scan_steps", lambda *t: pcurve._scan_steps_kernel(curve.PointP(*t)),
         lambda *t: pcurve.scan_steps_plain(curve.PointP(*t)), Pq, ends(-1, 8), ends(-1, 8),
         "lanes: first and last 8",
         6 * 32 * S * L5, 12 * mm * (S - 1) * L5, 5, variant="complete", lanes=L5, steps=S,
         team=pcurve.lane_team(L5))
    # K3: the bucket combine of one group, G x B lanes
    L3 = G * B
    inputs = points(L3) + points(L3)
    line("point_add", lambda *t: pcurve._add_launch(t, pcurve.point_add_team(L3)),
         lambda *t: pcurve.point_add_plain(curve.PointP(*t[:3]), curve.PointP(*t[3:])),
         inputs, ends(-1, 256), ends(-1, 256), "lanes: first and last 256", 9 * 32 * L3,
         12 * mm * L3, 5, lanes=L3, team=pcurve.point_add_team(L3))
    del inputs
    # K6: one group's bucket fold, G windows of B sums in chunks of 1,024
    blk = 1024 if B >= 2048 else 128              # the MSM's fold block
    Bp = -(-B // blk) * blk
    Pf = points(G, Bp)
    line("fold_lanes", lambda *t: pcurve._fold_lanes_kernel(curve.PointP(*t), blk),
         lambda *t: pcurve.fold_lanes_plain(curve.PointP(*t), blk), Pf, ends(1, 1),
         ends(1, 1), "groups: the first and the last",
         (3 * (Bp // blk) + 3) * 32 * G * blk, 12 * mm * (Bp // blk - 1) * G * blk, 5,
         variant="complete", groups=G, chunks=Bp // blk, blk=blk, lanes=G * blk,
         team=pcurve.lane_team(G * blk))
    # K3's tree: the 32 x 16 windows' partials after two halving adds
    Gt, w = K20_COLUMNS * W, pcurve.TREE_MAX
    line("point_reduce", lambda *t: pcurve._reduce_kernel(curve.PointP(*t)),
         lambda *t: pcurve.reduce_pairwise_plain(curve.PointP(*t)), points(Gt, w), ends(1, 2),
         ends(-1, 2), "groups: first and last 2",
         3 * 32 * Gt * w + 96 * Gt, 12 * mm * (w - 1) * Gt, 5, groups=Gt, w=w)
    # K7: 2^(c-1) * T_w over the 32 x 16 window totals
    Pd = points(K20_COLUMNS * W)
    line("dbl_pow2", lambda *t: pcurve._dbl_pow2_kernel(curve.PointP(*t), c - 1),
         lambda *t: pcurve.dbl_pow2_plain(curve.PointP(*t), c - 1), Pd, ends(-1, 4),
         ends(-1, 4), "lanes: first and last 4",
         6 * 32 * K20_COLUMNS * W, (c - 1) * 8 * mm * K20_COLUMNS * W, 5,
         lanes=K20_COLUMNS * W, c=c)
    # K8: Horner over W windows at c = 16, 32 columns
    V = points(W, K20_COLUMNS)
    line("horner", lambda *t: pcurve._horner_kernel(curve.PointP(*t), c),
         lambda *t: pcurve.horner_plain(curve.PointP(*t), c), V, ends(-1, 2), ends(-1, 2),
         "columns: first and last 2",
         3 * 32 * (W + 1) * K20_COLUMNS, W * (c * 8 + 12) * mm * K20_COLUMNS, 5,
         windows=W, c=c, width=K20_COLUMNS)
    # K9: gen_srs(20)'s doublings, 2^20 lanes
    Pn = points(n)
    line("point_dbl", lambda *t: pcurve._dbl_launch(t, pcurve.dbl_team(n)),
         lambda *t: pcurve.point_dbl_plain(curve.PointP(*t)), Pn, ends(-1, 4096),
         ends(-1, 4096), "lanes: first and last 4096",
         6 * 32 * n, 8 * mm * n, 5, lanes=n, team=pcurve.dbl_team(n))
    del Pn
    # the first-use power tables of the k = 20 prove, built on the card by
    # doubling (K1): the master twiddles of the 2^23 transforms (2^22
    # entries) and the coset powers and extended points (2^23), each timed
    # on its first build and held to host bigints at a sample of entries
    tables = {}
    for size, base in ((ext // 2, ntt.root_of_unity(FR, K20_EXT)), (ext, FR.generator)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pw = limbs.powers(FR, base, size, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        at = [0, 1, 2, size // 3, size - 1]
        got = limbs.decode(FR, pw[:, torch_index(at, dev)])
        ok = all(int(g) == pow(base, i, FR.modulus) for g, i in zip(got, at))
        tables[f"2^{size.bit_length() - 1}"] = {"seconds": seconds, "sample_equal": ok}
        if not ok:
            raise AssertionError(f"limbs.powers at {size} differs from host powers")
        del pw
    emit({"phase": "kernel", "kernel": "powers", "path": "conv2d_mnist k=20", "tables": tables})
    from ezkl_tpu_torch.kernels import build
    build.reset_launches()        # comparison launches do not count
    return rows


# ---------------------------------------------------------------------------
# phase 7: the device Poseidon hash
# ---------------------------------------------------------------------------

POSEIDON_N = 1 << 14
POSEIDON_SAMPLE = 64


def poseidon(dev, rng):
    import torch
    from ezkl_tpu_torch.fieldmath import limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr
    from ezkl_tpu_torch.kernels import build
    from ezkl_tpu_torch.kernels import poseidon as pos

    FR = bn254_fr()
    xs = [[int.from_bytes(rng.bytes(32), "little") % FR.modulus for _ in range(2)]
          for _ in range(POSEIDON_N)]
    inputs = limbs.to_device(limbs.encode(FR, xs), dev).movedim(1, 2).contiguous()  # (8, 2, n)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pos.hash_fixed_len(FR, inputs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    sample = rng.choice(POSEIDON_N, POSEIDON_SAMPLE, replace=False)
    got = limbs.decode(FR, out[:, torch.as_tensor(sample, device=dev)])
    bad = [int(i) for i, g in zip(sample, got) if int(g) != pos.host_hash(xs[i])]
    emit({"phase": "poseidon", "n": POSEIDON_N, "width": pos.WIDTH, "inputs_per_hash": 2,
          "sample": POSEIDON_SAMPLE, "mismatches": bad, "seconds": seconds,
          "mont_mul_launches": launches["mont_mul"], "launches": launches})
    if bad:
        raise AssertionError(f"device Poseidon differs from host_hash at {bad[:8]}")
    if launches["mont_mul"] <= 0:
        raise AssertionError("the device Poseidon launched no K1")


def _shape(row):
    return {k: v for k, v in row.items()
            if k in ("field", "n", "rows", "lanes", "steps", "groups", "chunks", "blk", "c",
                     "windows", "width", "columns", "team", "variant", "exponent", "k",
                     "passes", "w", "b", "points")}


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
    t0 = time.perf_counter()
    rows = check_kernels(dev, rng)
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    k20_rows = check_k20_widths(dev, rng)
    t_k20 = time.perf_counter() - t0
    t0 = time.perf_counter()
    srs, launches, srs_launches, (pk, asg, baseline) = prove(dev, rng)
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        resume(dev, pk, srs, asg, baseline, wd)
    t_resume = time.perf_counter() - t0
    t0 = time.perf_counter()
    unfused_launches = check_outputs(dev, rng, srs)
    t_check = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as wd:
        wd = pathlib.Path(wd)
        t0 = time.perf_counter()
        graph_launches, graph_srs_launches = graph(dev, wd / GRAPH_MODEL)
        t_graph = time.perf_counter() - t0
        t0 = time.perf_counter()
        conv_launches, conv_srs_launches = conv(
            dev, wd / CONV_MODEL, (wd / GRAPH_MODEL / "proof.json", wd / GRAPH_MODEL / "vk.key"))
        t_conv = time.perf_counter() - t0
        t0 = time.perf_counter()
        evm_launches = evm(dev, wd / CONV_MODEL, wd / GRAPH_MODEL)
        t_evm = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh_launches = mesh(dev, rng, (srs, pk, asg, baseline), wd / CONV_MODEL / "kzg.srs")
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the card widths prove once here (the whole script's time);
        # `tools/run_chip_phases.py families` also proves them warm and profiled
        family_launches = families(dev, wd / "families", once=True)
        t_families = time.perf_counter() - t0
    del pk, asg
    t0 = time.perf_counter()
    poseidon(dev, rng)
    emit({"phase": "times", "kernels_s": t_kernels, "k20_kernels_s": t_k20,
          "prove_phase_s": t_prove, "resume_s": t_resume, "check_s": t_check,
          "graph_s": t_graph, "conv2d_mnist_s": t_conv, "evm_s": t_evm, "mesh_s": t_mesh,
          "families_s": t_families, "poseidon_s": time.perf_counter() - t0})

    # launches: K1 (each form) to K8 from the graph phase's warm prove; K9
    # from its gen_srs, K9's path since the fused MSM (K7, K8) took over the
    # MSM's doublings; the stand-in circuit's counts beside them
    paths = {name: ("graph warm prove", graph_launches[name]) for name in graph_launches}
    paths["point_dbl"] = ("graph gen_srs", graph_srs_launches["point_dbl"])
    standin = dict(launches, point_dbl=srs_launches["point_dbl"])
    # the second path: conv2d_mnist's warm k = 20 prove, K9 in gen_srs(20)
    k20 = dict(conv_launches, point_dbl=conv_srs_launches["point_dbl"])
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "ok": rows[name]["max_abs_err"] == 0,
         "launches": paths[name][1], "launches_path": paths[name][0],
         "standin_launches": standin[name],
         "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "l2_ms": rows[name]["l2_ms"],
         "eager_ms": rows[name]["eager_ms"],
         "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
         "library_ms": None,
         "shape": _shape(rows[name]),
         "k20": {"path": "conv2d_mnist warm prove" if name != "point_dbl" else
                 "conv2d_mnist gen_srs(20)", "launches": k20[name],
                 "ms": k20_rows[name]["ms"], "bound_ms": k20_rows[name]["bound_ms"],
                 "bound_by": k20_rows[name]["bound_by"],
                 "max_abs_err": k20_rows[name]["max_abs_err"],
                 "checked": k20_rows[name]["checked"], "shape": _shape(k20_rows[name])},
         "evm_launches": {path: evm_launches[path][name] for path in evm_launches},
         "mesh_launches": mesh_launches[name],
         "families_launches": {model: family_launches[model].get(name, 0)
                               for model in family_launches}}
        for name, (src, rep) in KERNEL_META.items()],
        "create_proof_point_dbl_launches": launches["point_dbl"],
        "unfused_msm_point_dbl_launches": unfused_launches["point_dbl"]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Freeze the JAX package's K=4 reference outputs for the port's tests.

Runs `ezkl_tpu` once on the two circuits of `tests/test_plonk.py` (the
mul + lookup + copy circuit and the shuffle circuit) and writes, under
`tests/fixtures/torch_port/`:

  srs_k4.json        gen_srs(4): k, the G1 powers as (16, n) Montgomery limbs
                     (x, y, z), and the two G2 points
  <circuit>.json     vk.transcript_repr(), the fixed and sigma commitments,
                     and create_proof(..., seed=1).to_json()
  fused_<case>.json  the outputs of the fused MSM's point kernels (K4
                     prefix_scan_packed, K5 prefix_scan_steps, K6 fold_lanes,
                     K7 dbl_pow2, K8 horner_combine), `_prefix_points_fused`
                     and `_msm_multi_fused`, on the inputs of
                     `torch_port_circuits.fused_cases`, as (8, *batch) words
  graph_<model>/     the file pipeline of the JAX package's `api` on each
                     model of `torch_port_graph_models.MODELS`: network.onnx,
                     input.json, settings.json, model.compiled, kzg.srs (at
                     the settled k), witness.json, vk.key, proof.json
                     (`prove(seed=1)`), and mock.json (the MockProver's
                     failures on the honest witness and on one with a cell
                     corrupted); models that no test proves stop at
                     settings.json, model.compiled, witness.json (kzg.srs
                     where a column is committed) and mock.json

The port's tests (`tests/test_torch_prove.py`, `tests/test_torch_fused_msm.py`,
`tests/test_torch_graph.py`, `tests/test_torch_api.py`) compare against these
files, so the suite never compiles the JAX prover nor runs Pallas interpret
mode. The fused part runs the TPU kernels through the
Pallas interpreter (EZKL_TPU_PALLAS=1 EZKL_TPU_PALLAS_INTERPRET=1) in
subprocesses, as `tests/test_pallas_interpret.py` does (each job took 7 to
40 minutes on an 8-core CPU; the MSM cases' job peaks near 32 GB). Run from the repo
root (the proofs part compiles the JAX prover on the CPU: about half an hour
on 8 cores):

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py [--part proofs|fused|graph]

The graph part runs one subprocess per model, all at once unless `--jobs`
says otherwise (`--models a,b` for some of them): each compiles the JAX
package's gen_srs, keygen and prover for its shapes (about 4, 35 and 40
minutes on 8 shared cores; 87 minutes in all, 5-7 GB each).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

import torch_port_circuits as circuits  # noqa: E402
import torch_port_graph_models as graph_models  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "torch_port"
K = circuits.K
SEED = 1


def _pts(pts):
    return [None if p is None else [hex(p[0]), hex(p[1])] for p in pts]


def make_proofs():
    from ezkl_tpu.plonk import cs as csmod, keygen, prover, srs as srsmod
    from ezkl_tpu.plonk.assign import Assignment
    OUT.mkdir(parents=True, exist_ok=True)
    srs = srsmod.gen_srs(K)
    (OUT / "srs_k4.json").write_text(json.dumps({
        "k": K,
        "g1": {c: np.asarray(getattr(srs.g1, c)).astype(np.uint32).tolist() for c in "xyz"},
        "g2": [[hex(v) for v in xy] for xy in srs.g2],
        "s_g2": [[hex(v) for v in xy] for xy in srs.s_g2],
    }))
    for name, (build, fill) in circuits.CIRCUITS.items():
        cs, cols = build(csmod)
        asg = fill(cs, cols, Assignment)
        pk = keygen.keygen(cs, K, srs, asg)
        proof = prover.create_proof(pk, srs, asg, seed=SEED)
        (OUT / f"{name}.json").write_text(json.dumps({
            "seed": SEED,
            "vk_repr": pk.vk.transcript_repr().hex(),
            "fixed_commitments": _pts(pk.vk.fixed_commitments),
            "sigma_commitments": _pts(pk.vk.sigma_commitments),
            "proof": proof.to_json(),
        }, indent=1))
        print(f"wrote {name}.json", flush=True)


class _Proxy:
    """A module as seen through attribute overrides."""

    def __init__(self, base, **overrides):
        self._base, self._overrides = base, overrides

    def __getattr__(self, name):
        return self._overrides[name] if name in self._overrides else getattr(self._base, name)


def _eager_scan(f, init, xs, length=None):
    """`lax.scan` as a Python loop over the leading axis: the same values,
    with no compiled loop body."""
    import jax
    import jax.numpy as jnp
    n = length if xs is None else jax.tree.leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, None if xs is None else jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def _msm_kernels(jnp, pcurve, PointP):
    """Calls that compile, each, one interpreted kernel of the MSM cases
    (n = 32, c = 4, C = 2: 32 windows per group, 128 windows) at the shape
    those cases give it."""
    def z(*shape):
        return jnp.zeros(shape, jnp.uint32)

    def pts(*shape):
        return PointP(z(16, *shape), z(16, *shape), z(16, *shape))

    calls = [lambda n=128 << j: pcurve.add(pts(n), pts(n)) for j in range(7)]
    return calls + [
        lambda: pcurve.prefix_scan_packed(z(8, 32, 32), z(8, 32, 32), z(32, 32)),
        lambda: pcurve.prefix_scan_steps(pts(32, 32)),
        lambda: pcurve.prefix_scan_steps(pts(32, 1)),
        lambda: pcurve.fold_lanes(pts(32, 128), blk=128),
        lambda: pcurve.dbl_pow2(pts(128), 3),
        lambda: pcurve.horner_combine(pts(64, 2), 4),
    ]


def _fused_child(names):
    """Runs in an interpret-mode subprocess: the named cases of
    `circuits.fused_cases` through the JAX package's TPU kernel code. The
    MSM's `lax.scan` over its window groups runs as a Python loop, so that
    each interpreted kernel in its body compiles on its own instead of
    inside one XLA module of several kernel bodies, which XLA:CPU had not
    finished compiling after 80 minutes on an 8-core CPU; and before the
    MSM cases run, their kernels compile in threads at once."""
    import jax
    import jax.numpy as jnp
    import ezkl_tpu
    from ezkl_tpu.fieldmath import hostcurve, limbs
    from ezkl_tpu.fieldmath.curve import PointP
    from ezkl_tpu.fieldmath.spec import bn254_fq, bn254_fr
    from ezkl_tpu.kernels import msm, pcurve

    jax.config.update("jax_platforms", "cpu")
    cache = pathlib.Path(ezkl_tpu.cache_dir())
    cache.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(cache))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    assert msm._use_pallas() and limbs.pl_interpret(), "interpret mode must be on"
    FQ, FR = bn254_fq(), bn254_fr()

    def enc(vals):
        return jnp.asarray(limbs.encode(FQ, vals.tolist()))

    def words(a):
        a = np.asarray(a, np.uint32)
        return (a[0::2] | (a[1::2] << np.uint32(16))).tolist()

    cases = circuits.fused_cases(hostcurve)
    msm.jax = _Proxy(jax, lax=_Proxy(jax.lax, scan=_eager_scan))
    if any(cases[name]["kind"] == "msm_fused" for name in names):
        t0 = time.perf_counter()
        kernels = _msm_kernels(jnp, pcurve, PointP)
        with ThreadPoolExecutor(len(kernels)) as pool:
            for done in [pool.submit(lambda f=f: np.asarray(f().x)) for f in kernels]:
                done.result()
        print(f"compiled the MSM's kernels ({time.perf_counter() - t0:.1f} s)", flush=True)
    for name in names:
        t0 = time.perf_counter()
        case = cases[name]
        kind, coords = case["kind"], [enc(v) for v in case["p" if "p" in case else "xy"]]
        if kind == "scan_packed":
            out = pcurve.prefix_scan_packed(msm._pack2(coords[0]), msm._pack2(coords[1]),
                                            jnp.asarray(case["sn"], jnp.uint32))
        elif kind == "scan_steps":
            out = pcurve.prefix_scan_steps(PointP(*coords) if len(coords) == 3
                                           else tuple(coords))
        elif kind == "fold_lanes":
            out = pcurve.fold_lanes(PointP(*coords) if len(coords) == 3 else tuple(coords),
                                    blk=case["blk"])
        elif kind == "dbl_pow2":
            out = pcurve.dbl_pow2(PointP(*coords), case["c"])
        elif kind == "horner":
            out = pcurve.horner_combine(PointP(*coords), case["c"])
        elif kind == "prefix_points_fused":
            out = msm._prefix_points_fused(PointP(*coords))
        else:
            sc = jnp.asarray(limbs.encode(FR, case["scalars"].tolist(), mont=False))
            out = msm._msm_multi_fused(PointP(*coords), jnp.moveaxis(sc, 0, 1), c=case["c"],
                                       affine=case["affine"], signed=True)
        (OUT / f"fused_{name}.json").write_text(json.dumps(
            {"case": name, **{c: words(getattr(out, c)) for c in "xyz"}}))
        print(f"wrote fused_{name}.json ({time.perf_counter() - t0:.1f} s)", flush=True)


# Cases that share kernels run in one process (the persistent compile cache
# finds no interpreted kernel that another process compiled).
_FUSED_JOBS = [
    ["msm_fused_affine", "msm_fused_padded", "msm_fused_projective"],
    ["prefix_points_fused"], ["scan_packed"], ["scan_steps_complete"], ["scan_steps_mixed"],
    ["fold_complete"], ["fold_mixed"], ["dbl_pow2_c3", "horner"], ["dbl_pow2_c9"],
]


def make_fused():
    """The fused part, in subprocesses (one per core at a time) whose
    environment turns on the Pallas kernels in interpret mode before any
    kernel builder runs. XLA's fusion passes are off: the interpreted kernel
    bodies are graphs of ~10^5 small integer ops, which XLA:CPU otherwise
    takes tens of minutes and tens of GB to compile; the values are the
    same either way."""
    flags = os.environ.get("XLA_FLAGS", "") + " --xla_disable_hlo_passes=fusion,cpu-fusion"
    env = dict(os.environ, JAX_PLATFORMS="cpu", EZKL_TPU_PALLAS="1",
               EZKL_TPU_PALLAS_INTERPRET="1", XLA_FLAGS=flags.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    workers = os.cpu_count() or 1
    pending, running, failed = list(_FUSED_JOBS), [], []
    while pending or running:
        while pending and len(running) < workers:
            job = pending.pop(0)
            running.append((job, subprocess.Popen(
                [sys.executable, __file__, "--fused-child", ",".join(job)], env=env,
                cwd=str(ROOT))))
        time.sleep(2)
        for item in [r for r in running if r[1].poll() is not None]:
            running.remove(item)
            if item[1].returncode:
                failed.append(item[0])
    if failed:
        raise RuntimeError(f"fused fixture jobs failed: {failed}")


# The cell the mock check corrupts: in advice column a1 (index 1, where
# lookup inputs and outputs live), the middle one of the rows that copy
# constraints tie to other cells.
CORRUPT_COLUMN = 1


def corrupt_row(copies) -> int:
    """`copies`: an Assignment's batches (col_a, rows_a, col_b, rows_b)."""
    rows = sorted({int(r) for ca, ra, cb, rb in copies
                   for col, rs in ((ca, ra), (cb, rb))
                   if (str(col.kind), int(col.index)) == ("advice", CORRUPT_COLUMN)
                   for r in rs})
    return rows[len(rows) // 2]


def _failures(fails):
    return [[f.kind, f.name, [int(r) for r in f.rows]] for f in fails]


def _graph_child(name):
    """Runs in a subprocess: the JAX package's file pipeline on one model.
    A model that neither the CPU tests nor the card prove against the
    fixtures stops after the mock; a model `after` another waits for that
    one's witness.json, its input."""
    import jax
    import ezkl_tpu
    from ezkl_tpu import api
    from ezkl_tpu.graph import onnx_writer
    from ezkl_tpu.graph.run_args import RunArgs
    from ezkl_tpu.plonk import mock
    from ezkl_tpu.fieldmath.spec import FR_MODULUS
    from ezkl_tpu.plonk.cs import ADVICE, Column

    cache = pathlib.Path(ezkl_tpu.cache_dir())
    cache.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(cache))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    d = OUT / f"graph_{name}"
    d.mkdir(parents=True, exist_ok=True)
    model = graph_models.MODELS[name]
    if model.after:                          # written early in that model's job
        deadline = time.monotonic() + 4 * 3600
        while not (OUT / f"graph_{model.after}" / "witness.json").exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"no witness.json of {model.after}")
            time.sleep(5)
    onnx, inp = graph_models.build(name, onnx_writer, lambda other: OUT / f"graph_{other}")
    (d / "network.onnx").write_bytes(onnx)
    (d / "input.json").write_text(json.dumps(inp))
    times = {}

    def phase(label, fn):
        t0 = time.perf_counter()
        out = fn()
        times[label] = round(time.perf_counter() - t0, 1)
        print(f"{name}: {label} {times[label]} s", flush=True)
        return out

    f = {k: str(d / k) for k in ("network.onnx", "input.json", "settings.json",
                                 "model.compiled", "kzg.srs", "witness.json",
                                 "vk.key", "pk.key", "proof.json")}
    ra = graph_models.run_args(RunArgs, name)
    st = phase("gen_settings", lambda: api.gen_settings(f["network.onnx"], f["settings.json"], ra))
    api.compile_circuit(f["network.onnx"], f["settings.json"], f["model.compiled"])
    keyed = model.prove or model.card_proof
    committed = "kzgcommit" in (ra.input_visibility, ra.output_visibility,
                                ra.param_visibility)
    if keyed or committed:
        phase("gen_srs", lambda: api.gen_srs(f["kzg.srs"], st.run_args.logrows))
    phase("gen_witness", lambda: api.gen_witness(
        f["model.compiled"], f["input.json"], f["witness.json"],
        srs_path=f["kzg.srs"] if keyed or committed else None))

    gc = api.load_compiled(f["model.compiled"])
    arrays = api._reshape_for(gc, api._load_input(f["input.json"], gc.model.input_scales()))
    honest = phase("mock", lambda: gc.mock_prove(arrays))
    assert not honest, honest
    cfg, ctx, _ = gc.forward(arrays)
    asg = ctx.finalize()
    row = corrupt_row(asg.copies)
    col = Column(ADVICE, CORRUPT_COLUMN)
    asg.set_ints_at(col, [row], [asg.get_int(col, row) + 1])
    challenges = None
    if asg.phase_callback is not None:          # as GraphCircuit.mock_prove
        challenges = {i: pow(gc.MOCK_CHALLENGE, i + 1, FR_MODULUS)
                      for i in range(cfg.cs.num_challenges)}
        asg.apply_phase1(challenges)
    bad = mock.verify(asg, challenges)
    assert bad, "corrupting a cell went unnoticed"
    (d / "mock.json").write_text(json.dumps({
        "honest": _failures(honest), "column": CORRUPT_COLUMN, "row": row,
        "corrupted": _failures(bad)}, indent=1))
    if not keyed:
        print(f"{name}: k={st.run_args.logrows} {json.dumps(times)}", flush=True)
        return

    phase("setup", lambda: api.setup(f["model.compiled"], f["input.json"], f["kzg.srs"],
                                     f["vk.key"], f["pk.key"]))
    phase("prove", lambda: api.prove(f["model.compiled"], f["input.json"], f["pk.key"],
                                     f["kzg.srs"], f["proof.json"], seed=SEED))
    ok = phase("verify", lambda: api.verify(f["proof.json"], f["vk.key"], f["kzg.srs"]))
    assert ok, "the reference's proof does not verify"
    pathlib.Path(f["pk.key"]).unlink()       # large, and rebuilt by the tests' keygen
    print(f"{name}: k={st.run_args.logrows} {json.dumps(times)}", flush=True)


def make_graph(names=None, jobs=None):
    """The graph part: one subprocess per model (`names`, default all of
    MODELS), at most `jobs` at once (default all), in the order given."""
    OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    pending = list(names or graph_models.MODELS)
    for name in pending:                    # no stale input for a later part
        witness = OUT / f"graph_{name}" / "witness.json"
        if witness.exists():
            witness.unlink()
    jobs = jobs or len(pending)
    running, failed = {}, []
    while pending or running:
        while pending and len(running) < jobs:
            name = pending.pop(0)
            running[name] = subprocess.Popen(
                [sys.executable, __file__, "--graph-child", name], env=env, cwd=str(ROOT))
        time.sleep(2)
        for name, p in list(running.items()):
            if p.poll() is not None:
                del running[name]
                if p.returncode:
                    failed.append(name)
    if failed:
        raise RuntimeError(f"graph fixture jobs failed: {failed}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("all", "proofs", "fused", "graph"), default="all")
    ap.add_argument("--fused-child", help=argparse.SUPPRESS)
    ap.add_argument("--graph-child", help=argparse.SUPPRESS)
    ap.add_argument("--models", help="graph part: comma-separated names of "
                    "torch_port_graph_models.MODELS (default: all), run in this order")
    ap.add_argument("--jobs", type=int, help="graph part: subprocesses at once "
                    "(default: one per model)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    if args.fused_child:
        return _fused_child(args.fused_child.split(","))
    if args.graph_child:
        return _graph_child(args.graph_child)
    if args.part in ("all", "proofs"):
        make_proofs()
    if args.part in ("all", "fused"):
        make_fused()
    if args.part in ("all", "graph"):
        make_graph(args.models.split(",") if args.models else None, args.jobs)
    print(f"done in {time.perf_counter() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()

"""The port's mesh (`ezkl_tpu_torch.parallel.sharded`) on meshes of 2 and 4
CPU devices, against the single-device path (mirrors
`tests/test_parallel.py:23-110`; a CPU device runs the kernels' plain
versions, so every shard and every block copy of the all_to_all runs here as
on the cards).

Tolerances: the sharded MSM equal as an affine point to `hostcurve.g1_msm`;
the four-step transforms and `to_ext_sharded` word for word equal to
`ntt.ntt` / `ntt.intt` / `Domain.coeff_to_extended(intt(.))`, and round
trips exact; a seeded K=4 proof with the mesh set byte-equal to the JAX
package's frozen proof (to which `tests/test_torch_prove.py` holds the proof
made without a mesh), its commitments and extended-coset transforms having
gone through the sharded paths.
"""

import json
import pathlib
import random
import types

import numpy as np
import pytest
import torch

from ezkl_tpu_torch import convert
from ezkl_tpu_torch.fieldmath import curve, hostcurve, limbs
from ezkl_tpu_torch.fieldmath.spec import bn254_fr
from ezkl_tpu_torch.kernels import ntt as nttmod
from ezkl_tpu_torch.parallel import sharded
from ezkl_tpu_torch.plonk import cs, keygen, prover, verifier
from ezkl_tpu_torch.plonk.assign import Assignment
from ezkl_tpu_torch.plonk.domain import domain

import torch_port_circuits as circuits

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
FR = bn254_fr()
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _mesh(d):
    return sharded.make_mesh(devices=["cpu"] * d)


def _field(rows, n, seed):
    rng = random.Random(seed)
    vals = [[rng.randrange(FR.modulus) for _ in range(n)] for _ in range(rows)]
    return limbs.to_device(limbs.encode(FR, vals), "cpu")            # (8, rows, n)


def test_make_mesh_never_drops_devices(monkeypatch):
    assert sharded.make_mesh(devices=["cpu"] * 4) == (torch.device("cpu"),) * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharded.make_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    for bad in ({"n": 3}, {"n": 0}, {"n": 2, "devices": ["cpu"] * 3}):
        with pytest.raises(ValueError):
            sharded.make_mesh(**bad)


def test_mesh_env_installs_only_a_mesh_of_present_cards(monkeypatch):
    """EZKL_TPU_MESH=n installs the first n cards when n > 1 and that many
    exist, else nothing; set_mesh overrides it."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for env, want in (("2", 2), ("4", None), ("1", None)):
        monkeypatch.setenv("EZKL_TPU_MESH", env)
        monkeypatch.setattr(sharded, "_ENV_CHECKED", False)
        monkeypatch.setattr(sharded, "_ACTIVE_MESH", None)
        mesh = sharded.active_mesh()
        assert (mesh and len(mesh)) == want
    sharded.set_mesh(None)
    assert sharded.active_mesh() is None


@pytest.mark.parametrize("d, affine", [(2, False), (4, True)])
def test_msm_sharded_matches_host(d, affine):
    rng = random.Random(42)
    n = 16
    pts_host = [hostcurve.g1_mul(hostcurve.G1, rng.randrange(1, 1 << 28)) for _ in range(n)]
    scalars = [rng.randrange(FR.modulus) for _ in range(n)]
    sc = limbs.to_device(limbs.encode(FR, scalars, mont=False), "cpu")
    out = sharded.msm_sharded(_mesh(d), curve.encode_points(pts_host, "cpu"), sc, c=3,
                              affine=affine)
    assert curve.decode_points(out.map(lambda a: a[:, None]))[0] == \
        hostcurve.g1_msm(pts_host, scalars)


@pytest.mark.parametrize("d", [2, 4])
def test_ntt_sharded_matches_single_and_roundtrips(d):
    R = C = 16
    x = _field(1, R * C, d)[:, 0]                                    # (8, 256)
    mesh = _mesh(d)
    flat = sharded.from_fourstep_layout(
        sharded.ntt_sharded(mesh, FR, sharded.to_fourstep_layout(x, R, C)))
    assert torch.equal(flat, nttmod.ntt(FR, x))
    back = sharded.ntt_sharded(mesh, FR, sharded.to_fourstep_layout(flat, R, C), inverse=True)
    assert torch.equal(sharded.from_fourstep_layout(back), x)


@pytest.mark.parametrize("d", [2, 4])
def test_ntt_sharded_batched_matches_single(d):
    mesh = _mesh(d)
    B, n = 3, 512                          # shard_factors: (16, 32) on 2 and 4
    assert sharded.shard_factors(mesh, n) == (16, 32)
    x = _field(B, n, 7 + d)
    got = sharded.ntt_sharded_batched(mesh, FR, x)
    assert torch.equal(got, nttmod.ntt(FR, x))
    back = sharded.ntt_sharded_batched(mesh, FR, got, inverse=True)
    assert torch.equal(back, nttmod.intt(FR, got))
    assert torch.equal(back, x)


def test_shard_factors():
    assert sharded.shard_factors(_mesh(1), 256) is None
    assert sharded.shard_factors(_mesh(4), 8) is None           # n < d^2
    assert sharded.shard_factors(_mesh(4), 24) is None          # not a power of two
    assert sharded.shard_factors(_mesh(4), 128) == (8, 16)
    assert sharded.shard_factors(_mesh(2), 1 << 17) == (256, 512)


@pytest.mark.parametrize("d", [2, 4])
def test_to_ext_sharded_matches_domain(d):
    dom = domain(4)                        # n = 16, ext = 128: both shard on 2 and 4
    mesh = _mesh(d)
    assert sharded.shard_factors(mesh, dom.n_ext) is not None
    stack = _field(2, dom.n, 11).movedim(1, 0)                       # (2, 8, 16)
    got = sharded.to_ext_sharded(mesh, dom, stack)
    want = dom.coeff_to_extended(nttmod.intt(FR, stack.movedim(1, 0))).movedim(1, 0)
    assert torch.equal(got, want)
    assert torch.equal(sharded.to_ext_sharded(mesh, dom, stack[0]), want[0])


def test_prover_under_a_mesh_gives_the_frozen_proof(monkeypatch):
    """create_proof(seed=1) of the K=4 shuffle circuit with a mesh of two
    CPU devices set: every commitment through `msm_sharded` and every
    group of extended-coset transforms through `to_ext_sharded`, and the
    proof byte-equal to the JAX package's frozen one and accepted."""
    d = json.loads((FIXTURES / "srs_k4.json").read_text())
    g2 = lambda v: tuple(tuple(int(c, 16) for c in xy) for xy in v)   # noqa: E731
    srs = convert.srs_from_ref(types.SimpleNamespace(
        k=d["k"], g2=g2(d["g2"]), s_g2=g2(d["s_g2"]),
        g1=types.SimpleNamespace(**{c: np.asarray(d["g1"][c], np.uint32) for c in "xyz"})),
        "cpu")
    fx = json.loads((FIXTURES / "shuffle.json").read_text())
    build, fill = circuits.CIRCUITS["shuffle"]
    system, cols = build(cs)
    asg = fill(system, cols, Assignment)
    pk = keygen.keygen(system, circuits.K, srs, asg, device="cpu")

    calls = {"msm_sharded": 0, "to_ext_sharded": 0}
    for name in calls:
        real = getattr(sharded, name)

        def counted(*args, real=real, name=name, **kw):
            calls[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(sharded, name, counted)
    sharded.set_mesh(_mesh(2))
    try:
        proof = prover.create_proof(pk, srs, asg, seed=fx["seed"])
    finally:
        sharded.set_mesh(None)
    assert proof.to_json() == fx["proof"]
    assert verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
    commitments = sum(len(g) for g in (
        proof.advice_commitments, proof.lookup_m_commitments, proof.perm_z_commitments,
        proof.lookup_phi_commitments, proof.shuffle_z_commitments, [proof.random_commitment],
        proof.h_commitments, proof.opening_commitments))
    assert calls["msm_sharded"] == commitments
    assert calls["to_ext_sharded"] >= 1

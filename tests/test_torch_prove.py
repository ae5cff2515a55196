"""The whole slice at K=4: the port keys, proves and verifies both circuits
of `tests/test_plonk.py` on the CPU, against the JAX package's outputs frozen
by `tools/make_torch_fixtures.py` (`tests/fixtures/torch_port/`), so the
suite never compiles the JAX prover.

Tolerances: the SRS and the keys bit-exact; transcript challenges,
`vk.transcript_repr()` and `create_proof(seed=1).to_json()` byte-equal; the
JAX package's own verifier (`ezkl_tpu.plonk.verifier.verify`) accepts the
port's proofs; a key carried across by `convert.pk_from_ref` bit-exact."""

import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from ezkl_tpu.plonk import cs as ref_cs
from ezkl_tpu.plonk import keygen as ref_keygen
from ezkl_tpu.plonk import verifier as ref_verifier
from ezkl_tpu.plonk import prover as ref_prover
from ezkl_tpu.plonk.assign import Assignment as RefAssignment
from ezkl_tpu.plonk.domain import domain as ref_domain
from ezkl_tpu_torch import convert
from ezkl_tpu_torch.plonk import cs, keygen, prover, srs as srsmod, verifier
from ezkl_tpu_torch.plonk.assign import Assignment

import torch_port_circuits as circuits

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
K = circuits.K
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _load(name):
    return json.loads((FIXTURES / name).read_text())


def _pts(raw):
    return [None if p is None else (int(p[0], 16), int(p[1], 16)) for p in raw]


@pytest.fixture(scope="module")
def srs():
    d = _load("srs_k4.json")
    g2 = lambda v: tuple(tuple(int(c, 16) for c in xy) for xy in v)   # noqa: E731
    ref = types.SimpleNamespace(k=d["k"], g2=g2(d["g2"]), s_g2=g2(d["s_g2"]),
                                g1=types.SimpleNamespace(**{c: np.asarray(d["g1"][c], np.uint32)
                                                            for c in "xyz"}))
    return convert.srs_from_ref(ref, "cpu")


def _witness(name, tamper=False):
    """Port circuit + the reference's witness carried across by `convert`
    (equal to the one the port builds itself)."""
    build, fill = circuits.CIRCUITS[name]
    ref_system, ref_cols = build(ref_cs)
    ref_asg = fill(ref_system, ref_cols, RefAssignment, tamper=tamper)
    system, cols = build(cs)
    asg = convert.assignment_from_ref(ref_asg, system)
    own = fill(system, cols, Assignment, tamper=tamper)
    np.testing.assert_array_equal(asg.fixed, own.fixed)
    np.testing.assert_array_equal(asg.advice, own.advice)
    assert asg.instance == own.instance
    return ref_system, system, asg


def _ref_vk(ref_system, pk):
    return ref_keygen.VerifyingKey(
        cs=ref_system, k=K,
        domain=ref_domain(K, gate_degree=max(ref_system.max_gate_degree(), 2)),
        fixed_commitments=pk.vk.fixed_commitments,
        sigma_commitments=pk.vk.sigma_commitments)


@pytest.fixture(scope="module")
def keys(srs):
    """name -> (reference cs, port cs, witness, port pk), keyed once per
    circuit and shared by the tests below."""
    cache = {}

    def get(name):
        if name not in cache:
            ref_system, system, asg = _witness(name)
            cache[name] = (ref_system, system, asg,
                           keygen.keygen(system, K, srs, asg, device="cpu"))
        return cache[name]
    return get


@pytest.mark.parametrize("kind", ["Transcript", "KeccakTranscript", "EvmTranscript"])
def test_transcript_challenges_byte_identical_to_reference(kind):
    """Bytes, scalars (reduced mod r), points (identity = 64 zero bytes) and
    the challenge chaining give the reference's challenges."""
    from ezkl_tpu.plonk import transcript as ref_transcript
    from ezkl_tpu_torch.plonk import transcript
    own, ref = getattr(transcript, kind)(), getattr(ref_transcript, kind)()
    steps = [("common_bytes", b"vk"), ("common_scalar", -5), ("common_point", None),
             ("common_point", (1, 2)), ("common_scalar", 1 << 300)]
    for method, arg in steps:
        getattr(own, method)(arg)
        getattr(ref, method)(arg)
        assert own.challenge() == ref.challenge()


def test_decode_host_helpers_read_device_values(srs):
    """`decode_point_host` of an (8,) point and `decode_scalar_host` of an
    (8,) Montgomery scalar give host values."""
    from ezkl_tpu_torch.fieldmath import curve, limbs
    from ezkl_tpu_torch.fieldmath.spec import bn254_fr
    from ezkl_tpu_torch.plonk import transcript
    pts = curve.decode_points(srs.g1)
    assert transcript.decode_point_host(srs.g1.map(lambda a: a[:, 1])) == pts[1]
    assert transcript.decode_point_host(curve.identity((), "cpu")) is None
    v = limbs.to_device(limbs.encode(bn254_fr(), [12345]), "cpu")[:, 0]
    assert transcript.decode_scalar_host(v) == 12345


def test_gen_srs_bit_exact_vs_reference(srs):
    own = srsmod.gen_srs(K, device="cpu")
    for a, b in zip(own.g1, srs.g1):
        assert a.equal(b)
    assert own.g2 == srs.g2 and own.s_g2 == srs.s_g2


@pytest.mark.parametrize("name", sorted(circuits.CIRCUITS))
def test_keys_and_seeded_proof_byte_equal_to_reference(srs, keys, name):
    fx = _load(f"{name}.json")
    ref_system, system, asg, pk = keys(name)
    assert pk.vk.transcript_repr().hex() == fx["vk_repr"]
    assert pk.vk.fixed_commitments == _pts(fx["fixed_commitments"])
    assert pk.vk.sigma_commitments == _pts(fx["sigma_commitments"])

    proof = prover.create_proof(pk, srs, asg, seed=fx["seed"])
    assert proof.to_json() == fx["proof"]

    # the reference's verifier accepts the port's proof; the port's own
    # verifier accepts it and rejects a tampered instance
    ref_proof = ref_prover.Proof.from_json(proof.to_json())
    assert ref_verifier.verify(_ref_vk(ref_system, pk), srs.g2, srs.s_g2, ref_proof)
    assert verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
    if proof.instances and proof.instances[0]:
        bad = dataclasses.replace(proof, instances=[[proof.instances[0][0] + 1]])
        assert not verifier.verify(pk.vk, srs.g2, srs.s_g2, bad)


def test_tampered_shuffle_witness_is_rejected(srs, keys):
    """A proof of a non-permutation (`test_plonk.py:152-153`) must not verify."""
    ref_system, system, asg, pk = keys("shuffle")
    _, _, bad_asg = _witness("shuffle", tamper=True)
    proof = prover.create_proof(pk, srs, bad_asg, seed=3)
    assert not verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
    ref_proof = ref_prover.Proof.from_json(proof.to_json())
    assert not ref_verifier.verify(_ref_vk(ref_system, pk), srs.g2, srs.s_g2, ref_proof)


def test_pk_from_ref_carries_a_proving_key_across(keys):
    """A proving key in the reference's layout ((C, 16, n) 16-bit limbs,
    vk by attribute) comes back bit-exact through `convert.pk_from_ref`."""
    _, system, _, pk = keys("mul_lookup")
    as_ref = lambda stack: np.stack([convert.limbs_to_ref(c) for c in stack])  # noqa: E731
    ref = types.SimpleNamespace(
        vk=types.SimpleNamespace(k=K, fixed_commitments=pk.vk.fixed_commitments,
                                 sigma_commitments=pk.vk.sigma_commitments),
        fixed_lagrange=as_ref(pk.fixed_lagrange), sigma_lagrange=as_ref(pk.sigma_lagrange),
        perm_maps=pk.perm_maps)
    back = convert.pk_from_ref(ref, system, "cpu")
    assert back.vk.transcript_repr() == pk.vk.transcript_repr()
    assert back.fixed_lagrange.equal(pk.fixed_lagrange)
    assert back.sigma_lagrange.equal(pk.sigma_lagrange)
    np.testing.assert_array_equal(back.perm_maps, pk.perm_maps)

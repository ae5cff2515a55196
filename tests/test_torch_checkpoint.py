"""Restartable prove phases of the port (`prover._ProveCheckpoint`) on the
CPU, on the K=4 circuits of `tests/test_plonk.py`: a prove crashed at either
cut point ("cols" after phase 4b, "h" after phase 5b) and resumed gives the
JAX package's frozen seed-1 proof byte for byte; a checkpoint needs a
deterministic seed; another witness or seed never resumes from it; and the
directory name, the npz arrays and the JSON are the JAX package's
(`ezkl_tpu.plonk.prover._ProveCheckpoint` builds its name from stand-in
objects and loads the port's files, with no JAX compile)."""

import json
import pathlib
import types

import numpy as np
import pytest
import torch

from ezkl_tpu.plonk import prover as ref_prover
from ezkl_tpu_torch import convert
from ezkl_tpu_torch.plonk import cs, keygen, prover, verifier
from ezkl_tpu_torch.plonk.assign import Assignment

import torch_port_circuits as circuits

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
K = circuits.K
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _fixture(name):
    return json.loads((FIXTURES / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def srs():
    d = json.loads((FIXTURES / "srs_k4.json").read_text())
    g2 = lambda v: tuple(tuple(int(c, 16) for c in xy) for xy in v)   # noqa: E731
    ref = types.SimpleNamespace(k=d["k"], g2=g2(d["g2"]), s_g2=g2(d["s_g2"]),
                                g1=types.SimpleNamespace(**{c: np.asarray(d["g1"][c], np.uint32)
                                                            for c in "xyz"}))
    return convert.srs_from_ref(ref, "cpu")


def _witness(name, tamper=False):
    build, fill = circuits.CIRCUITS[name]
    system, cols = build(cs)
    return system, cols, fill(system, cols, Assignment, tamper=tamper)


@pytest.fixture(scope="module")
def keys(srs):
    cache = {}

    def get(name):
        if name not in cache:
            system, _, asg = _witness(name)
            cache[name] = keygen.keygen(system, K, srs, asg, device="cpu")
        return cache[name]
    return get


def _crash_at(monkeypatch, phase):
    """Make `prover._span` raise once, when phase `phase` starts."""
    real_span = prover._span
    fired = []

    def boom(msg, device=None):
        if msg == phase and not fired:
            fired.append(msg)
            raise RuntimeError(f"injected crash at {msg}")
        real_span(msg, device)

    monkeypatch.setattr(prover, "_span", boom)
    return lambda: monkeypatch.setattr(prover, "_span", real_span)


def _crash(monkeypatch, pk, srs, asg, root, phase, seed=1):
    restore = _crash_at(monkeypatch, phase)
    with pytest.raises(RuntimeError, match="injected crash"):
        prover.create_proof(pk, srs, asg, seed=seed, checkpoint_dir=str(root))
    restore()


@pytest.mark.parametrize("name, phase, saved", [
    ("shuffle", "phase5: quotient", "cols"),
    ("shuffle", "phase6: evaluations", "h"),
    ("mul_lookup", "phase5: quotient", "cols"),
])
def test_resume_after_a_crash_gives_the_frozen_proof(srs, keys, tmp_path, monkeypatch,
                                                     name, phase, saved):
    pk = keys(name)
    _, _, asg = _witness(name)
    _crash(monkeypatch, pk, srs, asg, tmp_path, phase)
    assert list(tmp_path.glob(f"prove-*/{saved}.npz")), f"no {saved} checkpoint"
    _, _, asg = _witness(name)
    proof = prover.create_proof(pk, srs, asg, seed=1, checkpoint_dir=str(tmp_path))
    assert proof.to_json() == _fixture(name)["proof"]
    assert verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
    assert not list(tmp_path.glob("prove-*/*"))          # cleared on success


def test_checkpoint_directory_from_the_environment(srs, keys, tmp_path, monkeypatch):
    """EZKL_TPU_CKPT_DIR enables the checkpoint as `checkpoint_dir` does."""
    pk = keys("mul_lookup")
    _, _, asg = _witness("mul_lookup")
    monkeypatch.setenv("EZKL_TPU_CKPT_DIR", str(tmp_path))
    restore = _crash_at(monkeypatch, "phase5: quotient")
    with pytest.raises(RuntimeError, match="injected crash"):
        prover.create_proof(pk, srs, asg, seed=1)
    restore()
    assert list(tmp_path.glob("prove-*/cols.npz"))


def test_checkpoint_needs_a_deterministic_seed(srs, keys, tmp_path, monkeypatch):
    pk = keys("mul_lookup")
    _, _, asg = _witness("mul_lookup")
    monkeypatch.delenv("EZKL_TPU_DET_SEED", raising=False)
    with pytest.raises(ValueError, match="deterministic seed"):
        prover.create_proof(pk, srs, asg, checkpoint_dir=str(tmp_path))


def test_a_stale_witness_or_seed_never_resumes(srs, keys, tmp_path, monkeypatch):
    """A checkpoint of (witness A, seed 1) is keyed apart from seed 3 and
    from a tampered witness B; a seed-3 prove of A starts afresh (and
    verifies) and leaves A's seed-1 checkpoint as it was."""
    pk = keys("shuffle")
    _, _, asg_a = _witness("shuffle")
    _crash(monkeypatch, pk, srs, asg_a, tmp_path, "phase5: quotient")
    (ckpt_a,) = tmp_path.glob("prove-*")
    before = {p.name: p.read_bytes() for p in ckpt_a.iterdir()}
    _, _, asg_b = _witness("shuffle", tamper=True)
    dirs = {prover._ProveCheckpoint(tmp_path / "names", pk, a, s).dir.name
            for a, s in ((asg_a, 1), (asg_a, 3), (asg_b, 1))}
    assert len(dirs) == 3
    _, _, asg_a = _witness("shuffle")
    proof = prover.create_proof(pk, srs, asg_a, seed=3, checkpoint_dir=str(tmp_path))
    assert verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
    assert [p.name for p in tmp_path.glob("prove-*")] == [ckpt_a.name]
    assert {p.name: p.read_bytes() for p in ckpt_a.iterdir()} == before


def test_directory_name_is_the_reference_checkpoints(keys, tmp_path):
    """The JAX package's `_ProveCheckpoint`, given stand-ins with the same
    vk repr, the advice in its layout, the instance and the seed, names the
    same directory."""
    for name in sorted(circuits.CIRCUITS):
        pk = keys(name)
        _, _, asg = _witness(name)
        for seed in (1, 77):
            ref_pk = types.SimpleNamespace(vk=types.SimpleNamespace(
                transcript_repr=pk.vk.transcript_repr))
            ref_asg = types.SimpleNamespace(advice=convert.stack_to_ref(asg.advice),
                                            instance=asg.instance)
            ref = ref_prover._ProveCheckpoint(tmp_path / "ref", ref_pk, ref_asg, seed)
            own = prover._ProveCheckpoint(tmp_path / "own", pk, asg, seed)
            assert own.dir.name == ref.dir.name


def test_checkpoint_files_are_in_the_reference_layout(srs, keys, tmp_path, monkeypatch):
    """After a crash at phase 6 both checkpoints exist; the JAX package's
    `_ProveCheckpoint.load` reads them: its JSON keys, the transcript state
    as hex, and (C, 16, n) / (16, n) uint32 arrays of 16-bit limbs that
    convert to the port's tensors word for word."""
    pk = keys("mul_lookup")
    _, _, asg = _witness("mul_lookup")
    _crash(monkeypatch, pk, srs, asg, tmp_path, "phase6: evaluations")
    own = prover._ProveCheckpoint(tmp_path, pk, asg, 1)
    ref = object.__new__(ref_prover._ProveCheckpoint)
    ref.dir = own.dir
    n = 1 << K
    for name, keys_want in (("cols", ["theta", "beta", "gamma", "challenges", "advice_comms",
                                      "m_comms", "z_comms", "phi_comms", "shz_comms", "r_comm",
                                      "transcript_state"]),
                            ("h", ["h_comms", "transcript_state"])):
        ref_meta, ref_arrays = ref.load(name)
        meta, arrays = own.load(name, "cpu")
        assert list(ref_meta) == keys_want and meta == ref_meta
        bytes.fromhex(meta["transcript_state"])
        assert set(ref_arrays) == set(arrays)
        for key, val in arrays.items():
            pairs = zip(val, ref_arrays[key]) if isinstance(val, list) else [(val, ref_arrays[key])]
            for t, r in pairs:
                r = np.asarray(r)
                assert r.dtype == np.uint32 and r.shape[-2:] == (16, n)
                assert r.max() < (1 << 16)
                back = (convert.stack_from_ref(r, "cpu") if r.ndim == 3
                        else convert.limbs_from_ref(r, "cpu"))
                assert back.equal(t)
    with np.load(own.dir / "cols.npz") as data:
        assert data["advice_l"].shape == (pk.vk.cs.num_advice, 16, n)
        assert int(data["z_list__len"]) == len(prover._kernels(pk).chunks)

"""The port's EVM leg (`ezkl_tpu_torch.evm`, the EVM functions of its API
and CLI) on the CPU, held against the JAX package's (`ezkl_tpu.evm`) on the
same inputs. No JAX prove or keygen runs here.

* Artifacts: for the frozen JAX files of `graph_mlp_4d` (vk.key, kzg.srs,
  proof.json) and for the two K=4 circuits of `tests/test_plonk.py` (their
  frozen commitments), the Solidity text (plain and reusable), the VKA text,
  the runtime bytecode, the initcode and the calldata are byte-equal to the
  JAX package's.
* Execution: a seeded port K=4 proof made with `EvmTranscript` is accepted
  by the bytecode on the in-repo EVM, and rejected (the call returns a word
  other than 1) with an eval + 1, an instance + 1 and an on-curve wrong
  commitment; an off-curve commitment and truncated calldata revert. Each
  form gives the same outcome on the four pairings of (port, JAX) EVM and
  (port, JAX) bytecode (mirrors `tests/test_evm.py:181-260`).
* A multi-phase (Freivalds) circuit is refused by both packages' generators.
* The generator's opening groups match the port's verifier, and its
  expression codegen matches the evaluator (`tests/test_evm.py:109-150`).
* The API and the CLI (`--device cpu`) write the JAX package's files
  (Verifier.sol, Verifier.bin, VerifierVKA.sol, contract.addr,
  evm_chain.json, calldata.bin) byte for byte.
"""

import dataclasses
import json
import pathlib
import shutil
import types

import numpy as np
import pytest
import torch

from ezkl_tpu import api as ref_api
from ezkl_tpu.evm import bytecode as ref_bytecode
from ezkl_tpu.evm import solidity as ref_solidity
from ezkl_tpu.evm import vm as ref_vm
from ezkl_tpu.plonk import cs as ref_cs
from ezkl_tpu.plonk import keygen as ref_keygen
from ezkl_tpu.plonk import serde as ref_serde
from ezkl_tpu.plonk import prover as ref_prover
from ezkl_tpu.plonk import verifier as ref_verifier
from ezkl_tpu.plonk.domain import domain as ref_domain
from ezkl_tpu.plonk.transcript import EvmTranscript as RefEvmTranscript
from ezkl_tpu_torch import api, convert
from ezkl_tpu_torch.__main__ import main as cli
from ezkl_tpu_torch.evm import bytecode, solidity, vm
from ezkl_tpu_torch.fieldmath import hostcurve
from ezkl_tpu_torch.fieldmath.spec import FR_MODULUS
from ezkl_tpu_torch.plonk import cs, keygen, prover, serde, srs as srsmod, verifier
from ezkl_tpu_torch.plonk.assign import Assignment
from ezkl_tpu_torch.plonk.domain import domain
from ezkl_tpu_torch.plonk.transcript import EvmTranscript

import torch_port_circuits as circuits

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
MLP = FIXTURES / "graph_mlp_4d"
K = circuits.K
ONE = (1).to_bytes(32, "big")
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _pts(raw):
    return [None if p is None else (int(p[0], 16), int(p[1], 16)) for p in raw]


@pytest.fixture(scope="module")
def srs():
    d = json.loads((FIXTURES / "srs_k4.json").read_text())
    g2 = lambda v: tuple(tuple(int(c, 16) for c in xy) for xy in v)   # noqa: E731
    ref = types.SimpleNamespace(k=d["k"], g2=g2(d["g2"]), s_g2=g2(d["s_g2"]),
                                g1=types.SimpleNamespace(**{c: np.asarray(d["g1"][c], np.uint32)
                                                            for c in "xyz"}))
    return convert.srs_from_ref(ref, "cpu")


def _k4_vks(name):
    """(port vk, JAX vk) of a K=4 circuit, with the commitments the JAX
    package froze (`tests/test_torch_prove.py` shows the port's keygen gives
    the same)."""
    fx = json.loads((FIXTURES / f"{name}.json").read_text())
    build, _ = circuits.CIRCUITS[name]
    out = []
    for csmod, dom, VK in ((cs, domain, keygen.VerifyingKey),
                           (ref_cs, ref_domain, ref_keygen.VerifyingKey)):
        system, _ = build(csmod)
        out.append(VK(cs=system, k=K, domain=dom(K, gate_degree=max(system.max_gate_degree(), 2)),
                      fixed_commitments=_pts(fx["fixed_commitments"]),
                      sigma_commitments=_pts(fx["sigma_commitments"])))
    return out


@pytest.fixture(scope="module")
def cases(srs):
    """name -> (port vk, JAX vk, (g2, s_g2), n_inst)."""
    vk, ref_vk = serde.load_vk(MLP / "vk.key"), ref_serde.load_vk(MLP / "vk.key")
    s = srsmod.load(MLP / "kzg.srs", "cpu")
    proof = json.loads((MLP / "proof.json").read_text())
    out = {"mlp_4d": (vk, ref_vk, (s.g2, s.s_g2), sum(len(c) for c in proof["instances"]))}
    for name in sorted(circuits.CIRCUITS):
        vk, ref_vk = _k4_vks(name)
        out[name] = (vk, ref_vk, (srs.g2, srs.s_g2), vk.cs.num_instance)
    return out


@pytest.fixture(scope="module")
def proven(srs):
    """The port's seeded K=4 `mul_lookup` proof with the EVM transcript, its
    pk and the JAX vk of the same circuit."""
    build, fill = circuits.CIRCUITS["mul_lookup"]
    system, cols = build(cs)
    asg = fill(system, cols, Assignment)
    pk = keygen.keygen(system, K, srs, asg, device="cpu")
    proof = prover.create_proof(pk, srs, asg, seed=1, transcript=EvmTranscript())
    ref_system, _ = build(ref_cs)
    ref_vk = ref_keygen.VerifyingKey(
        cs=ref_system, k=K,
        domain=ref_domain(K, gate_degree=max(ref_system.max_gate_degree(), 2)),
        fixed_commitments=pk.vk.fixed_commitments,
        sigma_commitments=pk.vk.sigma_commitments)
    return pk, ref_vk, proof


def _calldata(proof, tmp_path):
    p = tmp_path / "calldata_proof.json"
    p.write_text(proof.to_json())
    return api.encode_evm_calldata(str(p), output=None)


@pytest.mark.parametrize("name", ["mlp_4d"] + sorted(circuits.CIRCUITS))
def test_artifacts_byte_equal_to_the_jax_package(cases, name):
    vk, ref_vk, (g2, s_g2), n_inst = cases[name]
    for reusable in (False, True):
        assert (solidity.generate_verifier(vk, g2, s_g2, reusable=reusable)
                == ref_solidity.generate_verifier(ref_vk, g2, s_g2, reusable=reusable))
    assert solidity.generate_vka(vk, g2, s_g2) == ref_solidity.generate_vka(ref_vk, g2, s_g2)
    assert solidity.eval_label_list(vk) == ref_solidity.eval_label_list(ref_vk)
    rt = bytecode.emit_verifier(vk, g2, s_g2, n_inst)
    assert rt == ref_bytecode.emit_verifier(ref_vk, g2, s_g2, n_inst)
    assert bytecode.initcode(rt) == ref_bytecode.initcode(rt)


def test_multi_phase_circuits_are_refused_as_in_the_jax_package(srs):
    """A circuit with a challenge (the Freivalds check of
    `graph_gemm_freivalds`) has no EVM verifier in either package: both
    raise NotImplementedError, which names `disable_freivalds`."""
    path = FIXTURES / "graph_gemm_freivalds" / "vk.key"
    vk, ref_vk = serde.load_vk(path), ref_serde.load_vk(path)
    assert vk.cs.num_challenges == ref_vk.cs.num_challenges > 0
    for gen, key in ((solidity.generate_verifier, vk), (ref_solidity.generate_verifier, ref_vk),
                     (lambda *a: bytecode.emit_verifier(*a, 1), vk),
                     (lambda *a: ref_bytecode.emit_verifier(*a, 1), ref_vk)):
        with pytest.raises(NotImplementedError, match="disable_freivalds"):
            gen(key, srs.g2, srs.s_g2)


def test_calldata_byte_equal_to_the_jax_package(proven, tmp_path):
    _, _, proof = proven
    p = tmp_path / "proof.json"
    for src in (MLP / "proof.json", None):
        if src is None:
            p.write_text(proof.to_json())
        else:
            shutil.copy(src, p)
        assert api.encode_evm_calldata(str(p), output=None) == \
            ref_api.encode_evm_calldata(str(p), output=None)


def test_evm_proof_verifies_on_the_host(srs, proven):
    """Both packages' host verifiers accept the port's EVM-transcript proof
    with the EVM transcript; the default transcript derives other
    challenges and rejects it."""
    pk, ref_vk, proof = proven
    assert verifier.verify(pk.vk, srs.g2, srs.s_g2, proof, transcript=EvmTranscript())
    assert not verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)
    ref_proof = ref_prover.Proof.from_json(proof.to_json())
    assert ref_verifier.verify(ref_vk, srs.g2, srs.s_g2, ref_proof,
                               transcript=RefEvmTranscript())


def _tampered(form, proof, tmp_path):
    """Calldata of the proof in one of the checked forms."""
    if form == "eval":
        evals = dict(proof.evals)
        label = sorted(evals)[0]
        evals[label] = (evals[label] + 1) % FR_MODULUS
        return _calldata(dataclasses.replace(proof, evals=evals), tmp_path)
    if form == "instance":
        return _calldata(dataclasses.replace(
            proof, instances=[[(proof.instances[0][0] + 1) % FR_MODULUS]]), tmp_path)
    data = bytearray(_calldata(proof, tmp_path))
    if form == "commitment_on_curve":           # the first advice commitment -> 3G
        gx, gy = hostcurve.g1_mul(hostcurve.G1, 3)
        data[0:32], data[32:64] = int(gx).to_bytes(32, "big"), int(gy).to_bytes(32, "big")
    elif form == "commitment_off_curve":        # x + 1 leaves the curve
        data[0:32] = (int.from_bytes(data[0:32], "big") + 1).to_bytes(32, "big")
    elif form == "truncated":
        del data[-1]
    return bytes(data)


FORMS = {"valid": "accept", "eval": "reject", "instance": "reject",
         "commitment_on_curve": "reject", "commitment_off_curve": "revert",
         "truncated": "revert"}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_bytecode_outcome_on_both_evms(srs, proven, tmp_path, form):
    """The port's bytecode and the JAX package's, each deployed on the port's
    EVM and on the JAX package's, give the outcome of the form."""
    pk, ref_vk, proof = proven
    n_inst = sum(len(c) for c in proof.instances)
    codes = {"port": bytecode.initcode(bytecode.emit_verifier(pk.vk, srs.g2, srs.s_g2, n_inst)),
             "jax": ref_bytecode.initcode(ref_bytecode.emit_verifier(ref_vk, srs.g2, srs.s_g2,
                                                                     n_inst))}
    data = _tampered(form, proof, tmp_path) if form != "valid" else _calldata(proof, tmp_path)
    outcomes = {}
    for machine, mod in (("port", vm), ("jax", ref_vm)):
        for code_of, initcode in codes.items():
            E = mod.EVM()
            addr = E.deploy(initcode)
            try:
                out = E.call(addr, data)
                outcomes[machine, code_of] = "accept" if out == ONE else "reject"
            except mod.EvmRevert:
                outcomes[machine, code_of] = "revert"
    assert set(outcomes.values()) == {FORMS[form]}, outcomes


def test_opening_groups_match_the_verifier(proven):
    """The generator's multiopen groups mirror the verifier's: one opening
    commitment per rotation, every eval opened at least once."""
    pk, _, proof = proven
    groups = solidity.opening_groups(pk.vk)
    assert len(groups) == len(proof.opening_commitments)
    labels = solidity.eval_label_list(pk.vk)
    assert sorted(proof.evals) == labels
    assert sum(len(v) for v in groups.values()) >= len(labels)


@pytest.mark.parametrize("name", sorted(circuits.CIRCUITS))
def test_expr_codegen_matches_the_evaluator(name):
    """Gate expressions rendered to Python (the same tree walk as the
    Solidity render) equal `evaluate_at_point` on random query values."""
    from ezkl_tpu_torch.plonk.evaluator import evaluate_at_point

    system, _ = circuits.CIRCUITS[name][0](cs)
    rng = np.random.default_rng(0)
    qv = {(q.column.kind, q.column.index, q.rotation): int(rng.integers(0, 2**63))
          for q in system.all_queries()}
    ns = {"qv": qv, "R": FR_MODULUS, "mulmod": lambda a, b, m: (a * b) % m,
          "addmod": lambda a, b, m: (a + b) % m}
    polys = [g.poly for g in system.gates] + [e for sh in system.shuffles
                                              for side in (sh.input, sh.table) for e in side]
    assert polys
    for poly in polys:
        code = solidity.expr_code(poly, lambda k, i, r: f"qv[({k!r}, {i}, {r})]",
                                  lambda i: f"ch[{i}]", lang="py")
        assert eval(code, ns) == evaluate_at_point(poly, qv, {}) % FR_MODULUS


def _inputs(d, srs, pk, proof):
    d.mkdir()
    serde.save_vk(pk.vk, d / "vk.key")
    srsmod.save(srs, d / "kzg.srs")
    (d / "proof.json").write_text(proof.to_json())


def test_api_writes_the_jax_package_files(srs, proven, tmp_path):
    pk, _, proof = proven
    port, ref = tmp_path / "port", tmp_path / "jax"
    for d in (port, ref):
        _inputs(d, srs, pk, proof)
    files = lambda d: {p.name: p.read_bytes() for p in d.iterdir()}     # noqa: E731

    # proof.json next to sol_path: Verifier.bin too, deployed and verified
    api.create_evm_verifier(port / "vk.key", port / "kzg.srs", port / "Verifier.sol",
                            device="cpu")
    ref_api.create_evm_verifier(ref / "vk.key", ref / "kzg.srs", ref / "Verifier.sol")
    for d, mod in ((port, api), (ref, ref_api)):
        addr = mod.deploy_evm(d / "Verifier.bin", d / "contract.addr", d / "evm_chain.json")
        assert addr == "0x1000"
        assert mod.verify_evm(d / "proof.json", d / "contract.addr", d / "evm_chain.json")
        mod.encode_evm_calldata(d / "proof.json", d / "calldata.bin")
    assert files(port) == files(ref)
    assert {"Verifier.sol", "Verifier.bin", "contract.addr", "evm_chain.json",
            "calldata.bin"} <= set(files(port))

    # reusable: the VKA text and no bytecode; proof.json next to vk_path only
    # (not next to sol_path): no bytecode either, as in the JAX package
    for d, mod, kw in ((port, api, {"device": "cpu"}), (ref, ref_api, {})):
        (d / "vka").mkdir()
        (d / "far").mkdir()
        mod.create_evm_verifier(d / "vk.key", d / "kzg.srs", d / "vka" / "Verifier.sol",
                                reusable=True, **kw)
        mod.create_evm_verifier(d / "vk.key", d / "kzg.srs", d / "far" / "Verifier.sol", **kw)
    for sub, names in (("vka", {"Verifier.sol", "VerifierVKA.sol"}), ("far", {"Verifier.sol"})):
        assert set(files(port / sub)) == names
        assert files(port / sub) == files(ref / sub)
    with pytest.raises(RuntimeError, match="network"):
        api.deploy_evm(rpc_url="http://localhost:8545")
    with pytest.raises(RuntimeError, match="network"):
        api.verify_evm(rpc_url="http://localhost:8545")


def test_cli_evm_subcommands(srs, proven, tmp_path):
    """`create-evm-verifier`, `deploy-evm`, `verify-evm` and
    `encode-evm-calldata` with `--device cpu`: the API's files; verify-evm
    exits 0 on the proof and 1 on one that reverts, and raises (exit 1 from
    `python -m`) when the contract rejects, as the JAX package's CLI does."""
    pk, _, proof = proven
    d = tmp_path / "cli"
    _inputs(d, srs, pk, proof)
    p = {name: str(d / name) for name in (
        "vk.key", "kzg.srs", "proof.json", "Verifier.sol", "Verifier.bin", "contract.addr",
        "evm_chain.json", "calldata.bin", "bad_eval.json", "bad_point.json")}
    common = ["--device", "cpu"]
    cli(["create-evm-verifier", *common, "--vk-path", p["vk.key"], "--srs-path", p["kzg.srs"],
         "--sol-code-path", p["Verifier.sol"]])
    assert pathlib.Path(p["Verifier.bin"]).read_bytes() == bytecode.initcode(
        bytecode.emit_verifier(pk.vk, srs.g2, srs.s_g2, 1))
    cli(["deploy-evm", *common, "--bin-path", p["Verifier.bin"], "--addr-path",
         p["contract.addr"], "--chain-path", p["evm_chain.json"]])
    verify = ["verify-evm", *common, "--addr-path", p["contract.addr"], "--chain-path",
              p["evm_chain.json"], "--proof-path"]
    with pytest.raises(SystemExit) as ok:
        cli(verify + [p["proof.json"]])
    assert ok.value.code == 0
    cli(["encode-evm-calldata", *common, "--proof-path", p["proof.json"], "-O", p["calldata.bin"]])
    assert pathlib.Path(p["calldata.bin"]).read_bytes() == api.encode_evm_calldata(
        p["proof.json"], output=None)

    pj = json.loads(proof.to_json())
    label = sorted(pj["evals"])[0]
    pj["evals"][label] = hex((int(pj["evals"][label], 16) + 1) % FR_MODULUS)
    pathlib.Path(p["bad_eval.json"]).write_text(json.dumps(pj))
    with pytest.raises(RuntimeError, match="rejected"):
        cli(verify + [p["bad_eval.json"]])
    pj = json.loads(proof.to_json())
    pj["advice"][0][0] = hex(int(pj["advice"][0][0], 16) + 1)
    pathlib.Path(p["bad_point.json"]).write_text(json.dumps(pj))
    with pytest.raises(SystemExit) as bad:
        cli(verify + [p["bad_point.json"]])
    assert bad.value.code == 1

"""Proof aggregation of the port (`ezkl_tpu_torch.plonk.aggregate`,
`api.aggregate` / `api.verify_aggr`, the CLI's `aggregate` / `verify-aggr`)
on the CPU, host-only in both packages, on frozen proofs: the K=4 seed-1
proofs of `tests/test_plonk.py`'s circuits (`tests/fixtures/torch_port/
{mul_lookup,shuffle}.json`, with their vks rebuilt from the frozen
commitments) and the graph models' `proof.json` / `vk.key` files.

The aggregate artifact is byte-equal to `ezkl_tpu.plonk.aggregate`'s; the
verifier of either package accepts the other's artifact; a tampered inner
proof, an invalid proof and a wrong count are rejected; the CLI writes the
API's bytes and its `verify-aggr` exits 0 on the artifact and 1 on a
tampered one."""

import json
import pathlib

import pytest
import torch

from ezkl_tpu.plonk import aggregate as ref_aggregate
from ezkl_tpu.plonk import cs as ref_cs
from ezkl_tpu.plonk import keygen as ref_keygen
from ezkl_tpu.plonk import prover as ref_prover
from ezkl_tpu.plonk.domain import domain as ref_domain
from ezkl_tpu_torch import api
from ezkl_tpu_torch.__main__ import main as cli
from ezkl_tpu_torch.plonk import aggregate, cs, keygen
from ezkl_tpu_torch.plonk.domain import domain
from ezkl_tpu_torch.plonk.prover import Proof

import torch_port_circuits as circuits

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
K = circuits.K
GRAPH = ["mlp_4d", "conv_small"]          # two circuits of two sizes (k = 8, 9)
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _pts(raw):
    return [None if p is None else (int(p[0], 16), int(p[1], 16)) for p in raw]


def _g2():
    d = json.loads((FIXTURES / "srs_k4.json").read_text())
    g2 = lambda v: tuple(tuple(int(c, 16) for c in xy) for xy in v)   # noqa: E731
    return g2(d["g2"]), g2(d["s_g2"])


def _vk_and_proof(name, package):
    """(vk, proof) of a K=4 circuit in `package` ("port" or "ref"): the vk
    from the frozen commitments (no keygen), the frozen seed-1 proof."""
    fx = json.loads((FIXTURES / f"{name}.json").read_text())
    csmod, kg, dom, proof_cls = ((cs, keygen, domain, Proof) if package == "port" else
                                 (ref_cs, ref_keygen, ref_domain, ref_prover.Proof))
    system, _ = circuits.CIRCUITS[name][0](csmod)
    vk = kg.VerifyingKey(cs=system, k=K,
                         domain=dom(K, gate_degree=max(system.max_gate_degree(), 2)),
                         fixed_commitments=_pts(fx["fixed_commitments"]),
                         sigma_commitments=_pts(fx["sigma_commitments"]))
    assert vk.transcript_repr().hex() == fx["vk_repr"]
    return vk, proof_cls.from_json(fx["proof"])


ORDER = ["mul_lookup", "shuffle", "mul_lookup"]


@pytest.fixture(scope="module")
def inputs():
    """package -> (vks, proofs) in ORDER (a vk repeats for a repeated circuit)."""
    out = {}
    for package in ("port", "ref"):
        pairs = {name: _vk_and_proof(name, package) for name in set(ORDER)}
        out[package] = ([pairs[n][0] for n in ORDER], [pairs[n][1] for n in ORDER])
    return out


def test_aggregate_json_byte_equal_the_reference(inputs):
    own = json.dumps(aggregate.aggregate(*inputs["port"]))
    ref = json.dumps(ref_aggregate.aggregate(*inputs["ref"]))
    assert own == ref
    assert json.loads(own)["protocol"] == "ezkl-tpu-aggregate-v1"


def test_aggregate_round_trip_in_both_packages(inputs):
    g2, s_g2 = _g2()
    agg = json.loads(json.dumps(aggregate.aggregate(*inputs["port"])))
    assert aggregate.verify_aggregated(inputs["port"][0], agg, g2, s_g2)
    assert ref_aggregate.verify_aggregated(inputs["ref"][0], agg, g2, s_g2)
    ref_agg = ref_aggregate.aggregate(*inputs["ref"])
    assert aggregate.verify_aggregated(inputs["port"][0], ref_agg, g2, s_g2)


def test_tampered_invalid_and_miscounted_aggregates_are_rejected(inputs):
    g2, s_g2 = _g2()
    vks, proofs = inputs["port"]
    agg = aggregate.aggregate(vks, proofs)
    bad = json.loads(json.dumps(agg))
    label = sorted(bad["proofs"][1]["evals"])[0]
    bad["proofs"][1]["evals"][label] = hex(int(bad["proofs"][1]["evals"][label], 16) ^ 1)
    assert not aggregate.verify_aggregated(vks, bad, g2, s_g2)
    # an inner proof that does not verify is never aggregated
    with pytest.raises(ValueError, match="failed verification"):
        aggregate.aggregate(vks, [proofs[0], Proof.from_json(json.dumps(bad["proofs"][1])),
                                  proofs[2]])
    # wrong counts: vks against proofs, num_proofs against the proofs held
    with pytest.raises(ValueError, match="one vk per proof"):
        aggregate.aggregate(vks[:2], proofs)
    assert not aggregate.verify_aggregated(vks[:2], agg, g2, s_g2)
    assert not aggregate.verify_aggregated(vks, dict(agg, num_proofs=2), g2, s_g2)
    assert not aggregate.verify_aggregated(vks, dict(agg, protocol="v0"), g2, s_g2)


def test_cli_aggregate_and_verify_aggr_give_the_api_results(tmp_path):
    """Two graph models with different vks (k = 8 and 9): the API's and the
    CLI's `aggregate` write the same bytes, the JAX package's api writes
    them too, and `verify-aggr` (API and CLI, `--device cpu`) accepts the
    artifact and rejects it with an inner eval flipped."""
    from ezkl_tpu import api as ref_api

    proofs = [str(FIXTURES / f"graph_{m}" / "proof.json") for m in GRAPH]
    vks = [str(FIXTURES / f"graph_{m}" / "vk.key") for m in GRAPH]
    srs = str(FIXTURES / f"graph_{GRAPH[0]}" / "kzg.srs")
    api_out, cli_out, ref_out = (tmp_path / f"{p}.json" for p in ("api", "cli", "ref"))
    api.aggregate(proofs, vks, str(api_out))
    cli(["aggregate", "--proof-paths", *proofs, "--vk-paths", *vks, "-O", str(cli_out),
         "--device", "cpu"])
    ref_api.aggregate(proofs, vks, str(ref_out))
    assert cli_out.read_bytes() == api_out.read_bytes() == ref_out.read_bytes()
    assert api.verify_aggr(str(api_out), vks, srs, device="cpu")

    bad = json.loads(api_out.read_text())
    label = sorted(bad["proofs"][0]["evals"])[0]
    bad["proofs"][0]["evals"][label] = hex(int(bad["proofs"][0]["evals"][label], 16) ^ 1)
    bad_path = tmp_path / "bad.json"
    bad_path.write_text(json.dumps(bad))
    assert not api.verify_aggr(str(bad_path), vks, srs, device="cpu")
    for path, code in ((api_out, 0), (bad_path, 1)):
        with pytest.raises(SystemExit) as exc:
            cli(["verify-aggr", "--aggr-path", str(path), "--vk-paths", *vks,
                 "--srs-path", srs, "--device", "cpu"])
        assert exc.value.code == code


def test_split_parts_aggregate_as_in_the_jax_package(tmp_path):
    """The two mlp_4d split parts' frozen proofs, whose boundary columns are
    committed (unblinded): both packages write the same aggregate, which
    `verify_aggr` accepts, and reject it with an inner eval flipped."""
    from ezkl_tpu import api as ref_api

    parts = ["mlp_4d_split_0", "mlp_4d_split_1"]
    proofs = [str(FIXTURES / f"graph_{m}" / "proof.json") for m in parts]
    vks = [str(FIXTURES / f"graph_{m}" / "vk.key") for m in parts]
    srs = str(FIXTURES / f"graph_{parts[0]}" / "kzg.srs")
    api.aggregate(proofs, vks, str(tmp_path / "api.json"))
    ref_api.aggregate(proofs, vks, str(tmp_path / "ref.json"))
    assert (tmp_path / "api.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert api.verify_aggr(str(tmp_path / "api.json"), vks, srs, device="cpu")
    assert ref_api.verify_aggr(str(tmp_path / "api.json"), vks, srs)
    bad = json.loads((tmp_path / "api.json").read_text())
    label = sorted(bad["proofs"][1]["evals"])[0]
    bad["proofs"][1]["evals"][label] = hex(int(bad["proofs"][1]["evals"][label], 16) ^ 1)
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    assert not api.verify_aggr(str(tmp_path / "bad.json"), vks, srs, device="cpu")
    assert not ref_api.verify_aggr(str(tmp_path / "bad.json"), vks, srs)

"""The port's file API and CLI (`ezkl_tpu_torch.api`, `__main__`) on the
CPU, end to end, against the JAX package's files frozen by
`tools/make_torch_fixtures.py --part graph` in
`tests/fixtures/torch_port/graph_<model>/` (the suite never runs the JAX
prover or keygen).

For each model of `torch_port_graph_models.MODELS` that is marked to prove
the port runs gen_settings -> compile_circuit -> gen_srs -> gen_witness ->
setup -> prove(seed=1) with `device="cpu"`; the models whose proofs only
the card makes (`card_proof`: a CPU key and proof of each would take
minutes) have their frozen proofs verified here, and the split parts'
witnesses and commitments are the port's. Tolerances: `kzg.srs`, `witness.json`
(with the `kzgcommit` model's commitments), `vk.key` and the seeded
`proof.json` byte-equal to the reference's; the reference's host verifier
accepts the port's proof and the port's accepts the reference's, and both
reject the proof with its first eval's low bit flipped; a `pk.key` written
by either package loads in the other with equal arrays. One run of the CLI
(`--device cpu`) writes the same files as the API."""

import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from ezkl_tpu import api as ref_api
from ezkl_tpu.graph import onnx_writer as ref_writer
from ezkl_tpu.graph.run_args import RunArgs as RefRunArgs
from ezkl_tpu.plonk import prover as ref_prover
from ezkl_tpu.plonk import serde as ref_serde
from ezkl_tpu.plonk import verifier as ref_verifier
from ezkl_tpu_torch import api, convert
from ezkl_tpu_torch.__main__ import main as cli
from ezkl_tpu_torch.graph import onnx_writer
from ezkl_tpu_torch.graph.run_args import RunArgs
from ezkl_tpu_torch.plonk import serde, srs as srsmod
from ezkl_tpu_torch.plonk.prover import Proof

import torch_port_graph_models as models

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
MODELS = sorted(m for m in models.MODELS if models.MODELS[m].prove)
CARD_PROOF = sorted(m for m in models.MODELS if models.MODELS[m].card_proof)
SEED = 1
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _inputs(d, name):
    d.mkdir(parents=True, exist_ok=True)
    onnx, inp = models.build(name, onnx_writer)
    (d / "network.onnx").write_bytes(onnx)
    (d / "input.json").write_text(json.dumps(inp))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """name -> the directory of the port's API run on that model; one SRS
    per k, generated once and copied."""
    runs, srs_files = {}, {}

    def get(name):
        if name in runs:
            return runs[name]
        d = tmp_path_factory.mktemp(name)
        _inputs(d, name)
        f = {k: str(d / k) for k in ("network.onnx", "input.json", "settings.json",
                                     "model.compiled", "kzg.srs", "witness.json",
                                     "vk.key", "pk.key", "proof.json")}
        st = api.gen_settings(f["network.onnx"], f["settings.json"],
                              models.run_args(RunArgs, name))
        api.compile_circuit(f["network.onnx"], f["settings.json"], f["model.compiled"])
        k = st.run_args.logrows
        if k not in srs_files:
            api.gen_srs(f["kzg.srs"], k, device="cpu")
            srs_files[k] = f["kzg.srs"]
        else:
            shutil.copy(srs_files[k], f["kzg.srs"])
        api.gen_witness(f["model.compiled"], f["input.json"], f["witness.json"],
                        srs_path=f["kzg.srs"], device="cpu")
        api.setup(f["model.compiled"], f["input.json"], f["kzg.srs"], f["vk.key"],
                  f["pk.key"], device="cpu")
        api.prove(f["model.compiled"], f["input.json"], f["pk.key"], f["kzg.srs"],
                  f["proof.json"], seed=SEED, device="cpu")
        runs[name] = d
        return d
    return get


def _tampered(proof_json: str) -> str:
    """tools/prove_graded.py's tamper: the first eval's low bit flipped."""
    pj = json.loads(proof_json)
    label = sorted(pj["evals"])[0]
    pj["evals"][label] = hex(int(pj["evals"][label], 16) ^ 1)
    return json.dumps(pj)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("artifact", ["kzg.srs", "witness.json", "vk.key", "proof.json"])
def test_files_byte_equal_the_reference(run, name, artifact):
    got = (run(name) / artifact).read_bytes()
    assert got == (FIXTURES / f"graph_{name}" / artifact).read_bytes()


@pytest.mark.parametrize("name", MODELS)
def test_each_verifier_accepts_the_others_proof_and_rejects_the_tampered(run, name):
    d, fx = run(name), FIXTURES / f"graph_{name}"
    g2 = srsmod.load(d / "kzg.srs", "cpu")
    # the reference's host verifier, under the port's vk.key, on the port's proof
    ref_vk = ref_serde.load_vk(d / "vk.key")
    port_proof = (d / "proof.json").read_text()
    assert ref_verifier.verify(ref_vk, g2.g2, g2.s_g2, ref_prover.Proof.from_json(port_proof))
    assert not ref_verifier.verify(ref_vk, g2.g2, g2.s_g2,
                                   ref_prover.Proof.from_json(_tampered(port_proof)))
    # the port's verifier, under the reference's vk.key, on the reference's proof
    assert api.verify(fx / "proof.json", fx / "vk.key", fx / "kzg.srs", device="cpu")
    (d / "proof_bad.json").write_text(_tampered((fx / "proof.json").read_text()))
    assert not api.verify(d / "proof_bad.json", fx / "vk.key", fx / "kzg.srs", device="cpu")


@pytest.mark.parametrize("name", MODELS)
def test_pk_files_load_in_the_other_package(run, name, tmp_path):
    """The port's pk.key in the reference's loader, and a pk.key that the
    reference's `save_pk` writes in the port's: equal arrays both ways."""
    d = run(name)
    pk = serde.load_pk(d / "pk.key", "cpu")
    ref_pk = ref_serde.load_pk(d / "pk.key")
    np.testing.assert_array_equal(np.asarray(ref_pk.fixed_lagrange),
                                  convert.stack_to_ref(pk.fixed_lagrange))
    np.testing.assert_array_equal(np.asarray(ref_pk.sigma_lagrange),
                                  convert.stack_to_ref(pk.sigma_lagrange))
    np.testing.assert_array_equal(np.asarray(ref_pk.perm_maps), pk.perm_maps)
    assert ref_serde.vk_to_json(ref_pk.vk) == serde.vk_to_json(pk.vk)

    ref_serde.save_pk(ref_pk, tmp_path / "pk.key")
    back = serde.load_pk(tmp_path / "pk.key", "cpu")
    assert back.fixed_lagrange.equal(pk.fixed_lagrange)
    assert back.sigma_lagrange.equal(pk.sigma_lagrange)
    np.testing.assert_array_equal(back.perm_maps, pk.perm_maps)
    assert serde.vk_to_json(back.vk) == (d / "vk.key").read_text()


def test_swap_proof_commitments_is_a_no_op_on_the_honest_proof(run, tmp_path):
    """The kzgcommit model: the witness's commitments are the proof's."""
    d = run("mlp_4d_hashed")
    shutil.copy(d / "proof.json", tmp_path / "proof.json")
    wit = json.loads((d / "witness.json").read_text())
    assert wit["processed_commitments"]["advice_indices"]
    assert api.swap_proof_commitments(tmp_path / "proof.json", d / "witness.json")
    assert Proof.from_json((tmp_path / "proof.json").read_text()) == \
        Proof.from_json((d / "proof.json").read_text())
    assert api.verify(tmp_path / "proof.json", d / "vk.key", d / "kzg.srs", device="cpu")


def test_cli_writes_the_api_files(run, tmp_path, monkeypatch):
    """`python -m ezkl_tpu_torch ... --device cpu`, the seed from
    EZKL_TPU_DET_SEED, on mlp_4d: every file equals the API's."""
    name = "mlp_4d"
    api_dir = run(name)
    _inputs(tmp_path, name)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EZKL_TPU_DET_SEED", str(SEED))
    ra = models.MODELS[name].run_args
    lo, hi = ra["lookup_range"]
    dev = ["--device", "cpu"]
    cli(["gen-settings", "-M", "network.onnx", "--input-scale", str(ra["input_scale"]),
         "--param-scale", str(ra["param_scale"]), f"--lookup-range={lo},{hi}",
         "--decomp-base", str(ra["decomp_base"])] + dev)
    cli(["compile-circuit", "-M", "network.onnx"] + dev)
    k = json.loads((tmp_path / "settings.json").read_text())["run_args"]["logrows"]
    cli(["gen-srs", "--srs-path", "kzg.srs", "--logrows", str(k)] + dev)
    cli(["gen-witness", "--srs-path", "kzg.srs"] + dev)
    cli(["setup", "--srs-path", "kzg.srs", "--log-level", "warn"] + dev)
    cli(["prove", "--srs-path", "kzg.srs", "--log-level", "debug"] + dev)
    with pytest.raises(SystemExit) as done:
        cli(["verify", "--srs-path", "kzg.srs"] + dev)
    assert done.value.code == 0
    for artifact in ("settings.json", "model.compiled", "kzg.srs", "witness.json",
                     "vk.key", "proof.json"):
        assert (tmp_path / artifact).read_bytes() == (api_dir / artifact).read_bytes(), artifact


def test_gen_vk_from_pk_writes_the_setup_vk(run, tmp_path):
    d = run("conv_small")
    api.gen_vk_from_pk(d / "pk.key", tmp_path / "vk.key", device="cpu")
    assert (tmp_path / "vk.key").read_bytes() == (d / "vk.key").read_bytes()


def test_get_srs_truncates_a_larger_cached_srs(tmp_path, monkeypatch):
    """`get_srs` finds no kzg8.srs in the SRS repository, loads the cached
    kzg9.srs, truncates it to 2^8 points and saves the JAX package's k = 8
    file, byte for byte."""
    monkeypatch.setenv("EZKL_TPU_SRS_REPO", str(tmp_path / "repo"))
    (tmp_path / "repo").mkdir()
    shutil.copy(FIXTURES / "graph_conv_small" / "kzg.srs", tmp_path / "repo" / "kzg9.srs")
    s = api.get_srs(logrows=8, srs_path=tmp_path / "kzg8.srs", device="cpu")
    assert s.k == 8
    assert (tmp_path / "kzg8.srs").read_bytes() == \
        (FIXTURES / "graph_mlp_4d" / "kzg.srs").read_bytes()


def _both(tmp_path, name):
    """The model's network.onnx and input.json in ref/ and port/."""
    for sub in ("ref", "port"):
        _inputs(tmp_path / sub, name)
    return tmp_path / "ref", tmp_path / "port"


def test_host_entry_points_equal_the_reference(tmp_path):
    """gen_random_data, table, poseidon_hash and split_model, which run on
    the host in both packages."""
    ref, port = _both(tmp_path, "mlp_4d")
    ref_api.gen_random_data(ref / "network.onnx", ref / "random.json", seed=3)
    api.gen_random_data(port / "network.onnx", port / "random.json", seed=3)
    assert (port / "random.json").read_bytes() == (ref / "random.json").read_bytes()
    assert api.table(port / "network.onnx") == ref_api.table(ref / "network.onnx")
    assert api.poseidon_hash([1, 2, 3]) == ref_api.poseidon_hash([1, 2, 3])
    parts = api.split_model(port / "network.onnx", port / "input.json", parts=2)
    ref_parts = ref_api.split_model(ref / "network.onnx", ref / "input.json", parts=2)
    assert [p[1:] for p in parts] == [p[1:] for p in ref_parts]
    for (path, *_), (ref_path, *_) in zip(parts, ref_parts):
        assert pathlib.Path(path).read_bytes() == pathlib.Path(ref_path).read_bytes()


def test_calibrate_settings_equals_the_reference(tmp_path):
    """The calibration grid (host layouts and witnesses of each cell) and its
    choice, over two candidate scales."""
    ref, port = _both(tmp_path, "mlp_4d")
    for package_api, ra_cls, d in ((ref_api, RefRunArgs, ref), (api, RunArgs, port)):
        package_api.gen_settings(d / "network.onnx", d / "settings.json",
                                 models.run_args(ra_cls, "mlp_4d"))
    ref_api.calibrate_settings(ref / "network.onnx", ref / "input.json",
                               ref / "settings.json", scales=[2, 3])
    api.calibrate_settings(port / "network.onnx", port / "input.json",
                           port / "settings.json", scales=[2, 3], device="cpu")
    assert (port / "settings.json").read_bytes() == (ref / "settings.json").read_bytes()


@pytest.mark.parametrize("name", CARD_PROOF)
def test_each_verifier_accepts_the_frozen_card_proof_and_rejects_the_tampered(name, tmp_path):
    """lstm_bidi (k = 11) and the two split parts (committed boundary
    columns): the JAX package's
    seed=1 proof, which the card reproduces byte for byte (`chip_smoke.py`'s
    families phase), passes both verifiers; with its first eval's low bit
    flipped it passes neither."""
    fx = FIXTURES / f"graph_{name}"
    g2 = srsmod.load(fx / "kzg.srs", "cpu")
    proof = (fx / "proof.json").read_text()
    ref_vk = ref_serde.load_vk(fx / "vk.key")
    assert ref_verifier.verify(ref_vk, g2.g2, g2.s_g2, ref_prover.Proof.from_json(proof))
    assert not ref_verifier.verify(ref_vk, g2.g2, g2.s_g2,
                                   ref_prover.Proof.from_json(_tampered(proof)))
    assert api.verify(fx / "proof.json", fx / "vk.key", fx / "kzg.srs", device="cpu")
    (tmp_path / "proof_bad.json").write_text(_tampered(proof))
    assert not api.verify(tmp_path / "proof_bad.json", fx / "vk.key", fx / "kzg.srs",
                          device="cpu")


SPLIT = ["mlp_4d_split_0", "mlp_4d_split_1"]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The port's witnesses of the two split parts (part 1's input from
    part 0's witness), with the frozen SRS: name -> directory."""
    base, out = tmp_path_factory.mktemp("split"), {}
    for name in SPLIT:
        d = base / name
        d.mkdir()
        onnx, inp = models.build(name, onnx_writer, lambda other: out[other])
        (d / "network.onnx").write_bytes(onnx)
        (d / "input.json").write_text(json.dumps(inp))
        api.gen_settings(d / "network.onnx", d / "settings.json", models.run_args(RunArgs, name))
        api.compile_circuit(d / "network.onnx", d / "settings.json", d / "model.compiled")
        api.gen_witness(d / "model.compiled", d / "input.json", d / "witness.json",
                        srs_path=FIXTURES / f"graph_{name}" / "kzg.srs", device="cpu")
        out[name] = d
    return out


def _commitments(witness_path):
    pc = json.loads(pathlib.Path(witness_path).read_text())["processed_commitments"]
    return pc["advice_indices"], [[int(v, 16) for v in c] for c in pc["polycommit"]]


def test_split_proofs_link_through_their_boundary_commitment(split):
    """`tests/test_proof_split.py`: part 0's output commitment is part 1's
    input commitment, and each seeded proof carries its own in
    `advice[idx]`."""
    (idx0, c_out), (idx1, c_in) = (_commitments(split[name] / "witness.json")
                                   for name in SPLIT)
    assert len(c_out) == len(c_in) == 1 and c_out == c_in
    for name, idx, comm in ((SPLIT[0], idx0, c_out), (SPLIT[1], idx1, c_in)):
        assert (split[name] / "witness.json").read_bytes() == \
            (FIXTURES / f"graph_{name}" / "witness.json").read_bytes()
        pj = json.loads((FIXTURES / f"graph_{name}" / "proof.json").read_text())
        assert [[int(v, 16) for v in pj["advice"][i]] for i in idx] == comm


def test_split_link_breaks_on_a_boundary_one_step_off(split, tmp_path):
    """Part 1's input moved by one quantisation step (2^-2) commits to
    another point."""
    d1 = split[SPLIT[1]]
    inp = json.loads((d1 / "input.json").read_text())
    inp["input_data"][0][0] += 0.25
    (tmp_path / "input.json").write_text(json.dumps(inp))
    api.gen_witness(d1 / "model.compiled", tmp_path / "input.json", tmp_path / "witness.json",
                    srs_path=FIXTURES / f"graph_{SPLIT[1]}" / "kzg.srs", device="cpu")
    assert _commitments(tmp_path / "witness.json")[1] != _commitments(d1 / "witness.json")[1]


@pytest.mark.parametrize("name", SPLIT)
def test_swap_of_a_doctored_commitment_is_refused_by_both_verifiers(split, tmp_path, name):
    """`tests/test_visibility.py:96-107`, on the seeded proof: the honest
    swap is a no-op; a witness whose commitment is 7G swaps in,
    `swap_proof_commitments` returns False, and neither package's verifier
    accepts the proof."""
    fx = FIXTURES / f"graph_{name}"
    shutil.copy(fx / "proof.json", tmp_path / "proof.json")
    assert api.swap_proof_commitments(tmp_path / "proof.json", split[name] / "witness.json")
    assert (Proof.from_json((tmp_path / "proof.json").read_text())
            == Proof.from_json((fx / "proof.json").read_text()))
    assert api.verify(tmp_path / "proof.json", fx / "vk.key", fx / "kzg.srs", device="cpu")
    wit = json.loads((split[name] / "witness.json").read_text())
    from ezkl_tpu_torch.fieldmath import hostcurve
    x, y = hostcurve.g1_mul(hostcurve.G1, 7)
    wit["processed_commitments"]["polycommit"][0] = [hex(x), hex(y)]
    (tmp_path / "witness.json").write_text(json.dumps(wit))
    assert not api.swap_proof_commitments(tmp_path / "proof.json", tmp_path / "witness.json")
    assert not api.verify(tmp_path / "proof.json", fx / "vk.key", fx / "kzg.srs", device="cpu")
    g2 = srsmod.load(fx / "kzg.srs", "cpu")
    assert not ref_verifier.verify(ref_serde.load_vk(fx / "vk.key"), g2.g2, g2.s_g2,
                                   ref_prover.Proof.from_json(
                                       (tmp_path / "proof.json").read_text()))


def test_a_gathered_value_off_its_table_stops_the_prover_in_phase_3(run):
    """gather_dyn: with one gathered value moved by one, the prover's
    multiplicity count over the advice table (phase 3) raises, as the JAX
    package's does."""
    from ezkl_tpu_torch.plonk import prover
    d = run("gather_dyn")
    gc = api.load_compiled(d / "model.compiled")
    arrays = api._reshape_for(gc, api._load_input(d / "input.json", gc.model.input_scales()))
    cfg, ctx, _ = gc.forward(arrays)
    asg = ctx.finalize()
    row, col = models.gathered_cell(asg, cfg)
    asg.set_ints_at(col, [row], [asg.get_int(col, row) + 1])
    pk = serde.load_pk(d / "pk.key", "cpu")
    with pytest.raises(ValueError, match=r"lookup 'dyn_gather_\d+': 1 input values not in table"):
        prover.create_proof(pk, srsmod.load(d / "kzg.srs", "cpu"), asg, seed=SEED)

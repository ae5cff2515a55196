"""The port's file API and CLI (`ezkl_tpu_torch.api`, `__main__`) on the
CPU, end to end, against the JAX package's files frozen by
`tools/make_torch_fixtures.py --part graph` in
`tests/fixtures/torch_port/graph_<model>/` (the suite never runs the JAX
prover or keygen).

For each model of `torch_port_graph_models.MODELS` the port runs
gen_settings -> compile_circuit -> gen_srs -> gen_witness -> setup ->
prove(seed=1) with `device="cpu"`. Tolerances: `kzg.srs`, `witness.json`
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
MODELS = sorted(models.MODELS)
SEED = 1
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _inputs(d, name):
    d.mkdir(parents=True, exist_ok=True)
    onnx, inp = models.MODELS[name][0](onnx_writer)
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
    ra = models.MODELS[name][1]
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

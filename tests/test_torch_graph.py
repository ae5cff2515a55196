"""The port's graph layer (`ezkl_tpu_torch/graph/`) against the JAX
package's, on the models of `torch_port_graph_models.MODELS`, on the CPU.

Everything here but the MockProver runs on the host in both packages, so it
is computed live in both: the `onnx_writer` bytes, `settings.json`,
`model.compiled` and `witness.json` byte-equal, and the finalized
assignment (every fixed and advice cell, the instance, the copy
constraints, and the Freivalds second-phase columns) equal word for word.
The port's MockProver runs on the CPU tensor route; the JAX package's
failure lists, on the honest witness and on one with a cell corrupted, are
frozen in `tests/fixtures/torch_port/graph_<model>/mock.json`
(`tools/make_torch_fixtures.py --part graph`) and must be equal. The
`kzgcommit` model's witness holds device commitments:
`tests/test_torch_api_mlp_4d_hashed.py` checks it."""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from ezkl_tpu import api as ref_api
from ezkl_tpu.graph import onnx_writer as ref_writer
from ezkl_tpu.graph.run_args import RunArgs as RefRunArgs
from ezkl_tpu_torch import api, convert
from ezkl_tpu_torch.graph import onnx_writer, ops
from ezkl_tpu_torch.graph.run_args import RunArgs
from ezkl_tpu_torch.plonk import mock
from ezkl_tpu_torch.fieldmath import limbs
from ezkl_tpu_torch.plonk.cs import ADVICE, FIXED, Column

import torch_port_graph_models as models
from test_torch_field import words_oracle

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
MODELS = sorted(models.MODELS)


def _committed(name):
    return "kzgcommit" in (models.MODELS[name].run_args.get(v) for v in (
        "input_visibility", "output_visibility", "param_visibility"))


# a committed column's witness holds KZG commitments, which the JAX package
# computes on its device: those witnesses are held to the frozen files (here
# for the models that no CPU test proves; `tests/test_torch_api_<model>.py`
# for the others)
HOST_WITNESS = [m for m in MODELS if not _committed(m)]
FROZEN_WITNESS = [m for m in MODELS if _committed(m) and not models.MODELS[m].prove]
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _files(root, package_api, run_args_cls, writer, name):
    """settings.json and model.compiled of one package under `root`."""
    root.mkdir(parents=True, exist_ok=True)
    onnx, inp = models.build(name, writer)
    (root / "network.onnx").write_bytes(onnx)
    (root / "input.json").write_text(json.dumps(inp))
    package_api.gen_settings(root / "network.onnx", root / "settings.json",
                             models.run_args(run_args_cls, name))
    package_api.compile_circuit(root / "network.onnx", root / "settings.json",
                                root / "model.compiled")
    return root


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> (reference directory, port directory)."""
    cache = {}

    def get(name):
        if name not in cache:
            base = tmp_path_factory.mktemp(name)
            cache[name] = (_files(base / "ref", ref_api, RefRunArgs, ref_writer, name),
                           _files(base / "port", api, RunArgs, onnx_writer, name))
        return cache[name]
    return get


@pytest.mark.parametrize("name", MODELS)
def test_onnx_writer_bytes_equal_the_reference(name):
    assert models.build(name, onnx_writer)[0] == models.build(name, ref_writer)[0]


def test_mlp_4d_is_the_graded_model(tmp_path):
    """`chip_smoke.mlp_4d` (the model the card proves, and the tests' mlp_4d)
    writes the bytes and input of `examples/gen_graded.py`'s mlp_4d."""
    sys.path.insert(0, str(ROOT / "examples"))
    import gen_graded
    gen_graded.gen_mlp_4d(tmp_path)
    onnx, inp = models.mlp_4d(onnx_writer)
    assert onnx == (tmp_path / "mlp_4d.onnx").read_bytes()
    assert json.dumps(inp) == (tmp_path / "mlp_4d_input.json").read_text()


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("artifact", ["settings.json", "model.compiled"])
def test_settings_and_compiled_byte_equal_the_reference(files, name, artifact):
    ref, port = files(name)
    assert (port / artifact).read_bytes() == (ref / artifact).read_bytes()
    fx = FIXTURES / f"graph_{name}" / artifact
    assert (port / artifact).read_bytes() == fx.read_bytes()


@pytest.mark.parametrize("name", HOST_WITNESS)
def test_witness_byte_equal_the_reference(files, name):
    ref, port = files(name)
    ref_api.gen_witness(ref / "model.compiled", ref / "input.json", ref / "witness.json")
    api.gen_witness(port / "model.compiled", port / "input.json", port / "witness.json",
                    device="cpu")
    assert (port / "witness.json").read_bytes() == (ref / "witness.json").read_bytes()


@pytest.mark.parametrize("name", FROZEN_WITNESS)
def test_committed_witness_byte_equal_the_frozen_reference(files, name, tmp_path):
    """The witness with its input and output commitments (the frozen SRS)."""
    _, port = files(name)
    fx = FIXTURES / f"graph_{name}"
    api.gen_witness(port / "model.compiled", port / "input.json", tmp_path / "witness.json",
                    srs_path=fx / "kzg.srs", device="cpu")
    assert (tmp_path / "witness.json").read_bytes() == (fx / "witness.json").read_bytes()


def _assignments(files, name):
    """The finalized assignments of both packages on the model's input."""
    out = []
    for package_api, d in zip((ref_api, api), files(name)):
        gc = package_api.load_compiled(d / "model.compiled")
        arrays = package_api._reshape_for(
            gc, package_api._load_input(d / "input.json", gc.model.input_scales()))
        cfg, ctx, _ = gc.forward(arrays)
        out.append((gc, cfg, ctx.finalize()))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_finalized_assignment_equals_the_reference(files, name):
    """Every cell, the instance and the copies; with the Freivalds route's
    second-phase advice filled by the same challenge in both."""
    (ref_gc, ref_cfg, ref_asg), (gc, cfg, asg) = _assignments(files, name)
    assert (asg.phase_callback is None) == (ref_asg.phase_callback is None)
    if asg.phase_callback is not None:
        challenges = {i: pow(gc.MOCK_CHALLENGE, i + 1, mock.FR.modulus)
                      for i in range(cfg.cs.num_challenges)}
        asg.apply_phase1(challenges)
        ref_asg.apply_phase1(challenges)
    np.testing.assert_array_equal(asg.fixed, convert._stack_words(ref_asg.fixed))
    np.testing.assert_array_equal(asg.advice, convert._stack_words(ref_asg.advice))
    assert asg.instance == ref_asg.instance
    assert len(asg.copies) == len(ref_asg.copies)
    for (ca, ra, cb, rb), (xa, qa, xb, qb) in zip(asg.copies, ref_asg.copies):
        assert (ca.kind, ca.index, cb.kind, cb.index) == (xa.kind, xa.index, xb.kind, xb.index)
        np.testing.assert_array_equal(ra, qa)
        np.testing.assert_array_equal(rb, qb)
    assert sorted(cfg.tables) == sorted(ref_cfg.tables)


@pytest.mark.parametrize("name", ["mlp_4d", "mlp_4d_hashed", "gemm_freivalds"])
def test_finalized_words_are_the_object_int_encoding(files, name):
    """`LayoutCtx.finalize` writes each fixed and advice column as the
    object-int encoding of the layout's int64 column with its full-field
    cells laid over it; the instance reaches the device as the encoding of
    its ints; `apply_phase1` writes the encoding of the Freivalds columns."""
    gc = api.load_compiled(files(name)[1] / "model.compiled")
    arrays = api._reshape_for(gc, api._load_input(files(name)[1] / "input.json",
                                                  gc.model.input_scales()))
    cfg, ctx, _ = gc.forward(arrays)
    asg = ctx.finalize()
    p = mock.FR.modulus
    want = {FIXED: np.zeros_like(asg.fixed), ADVICE: np.zeros_like(asg.advice)}
    for (kind, idx), arr in ctx._cols.items():
        want[kind][idx] = words_oracle(p, arr)
        for row, v in ctx._overlay.get((kind, idx), {}).items():
            want[kind][idx][:, row] = words_oracle(p, [v])[:, 0]
    if asg.phase_callback is not None:
        challenges = {i: pow(gc.MOCK_CHALLENGE, i + 1, p) for i in range(cfg.cs.num_challenges)}
        for idx, values in asg.phase_callback(challenges).items():
            want[ADVICE][idx] = words_oracle(p, values)
        asg.apply_phase1(challenges)
    np.testing.assert_array_equal(asg.fixed, want[FIXED])
    np.testing.assert_array_equal(asg.advice, want[ADVICE])
    inst = np.zeros((cfg.cs.num_instance, 8, asg.n), np.uint32)
    for i, vals in enumerate(asg.instance):
        inst[i][:, :len(vals)] = words_oracle(p, vals, mock.FR.r)
    np.testing.assert_array_equal(limbs.host_words(asg.instance_device("cpu")), inst)
    assert any(asg.instance) and (name != "mlp_4d_hashed" or ctx._overlay)
    assert (asg.phase_callback is not None) == (name == "gemm_freivalds")


def _failures(fails):
    return [[f.kind, f.name, [int(r) for r in f.rows]] for f in fails]


@pytest.mark.parametrize("name", MODELS)
def test_mock_failure_lists_equal_the_reference(files, name):
    """The port's MockProver passes the honest witness and, with the cell
    the fixture names corrupted by +1, reports the reference's failures."""
    sys.path.insert(0, str(ROOT / "tools"))
    import make_torch_fixtures as fixtures

    fx = json.loads((FIXTURES / f"graph_{name}" / "mock.json").read_text())
    _, port = files(name)
    gc = api.load_compiled(port / "model.compiled")
    arrays = api._reshape_for(gc, api._load_input(port / "input.json", gc.model.input_scales()))
    assert _failures(gc.mock_prove(arrays, device="cpu")) == fx["honest"] == []

    cfg, ctx, _ = gc.forward(arrays)
    asg = ctx.finalize()
    row = fixtures.corrupt_row(asg.copies)
    assert (fx["column"], fx["row"]) == (fixtures.CORRUPT_COLUMN, row)
    col = Column(ADVICE, fixtures.CORRUPT_COLUMN)
    asg.set_ints_at(col, [row], [asg.get_int(col, row) + 1])
    challenges = None
    if asg.phase_callback is not None:
        challenges = {i: pow(gc.MOCK_CHALLENGE, i + 1, mock.FR.modulus)
                      for i in range(cfg.cs.num_challenges)}
        asg.apply_phase1(challenges)
    got = _failures(mock.verify(asg, challenges, device="cpu"))
    assert got and got == fx["corrupted"]


def _elu_model(alphas):
    nodes = [onnx_writer.node("Elu", ["x"], ["h"], name="e0", alpha=alphas[0]),
             onnx_writer.node("Elu", ["h"], ["y"], name="e1", alpha=alphas[1])]
    return onnx_writer.model(nodes, {"x": (1, 4)}, {"y": (1, 4)}, {})


def test_tables_are_keyed_by_the_parameters_of_their_function(tmp_path, monkeypatch):
    """Two Elu nodes with different alpha get two tables (the JAX package
    names both "elu" and proves the second with the first's table); the
    on-disk table cache is keyed the same way."""
    monkeypatch.setenv("EZKL_TPU_CACHE", str(tmp_path))
    monkeypatch.setattr(ops, "_table_cache_store",
                        lambda tname, ys: stored.append(tname))
    stored = []
    (tmp_path / "m.onnx").write_bytes(_elu_model((1.0, 0.5)))
    ra = RunArgs(input_scale=2, param_scale=2, lookup_range=(-64, 64), decomp_base=32)
    st = api.gen_settings(tmp_path / "m.onnx", tmp_path / "s.json", ra)
    elu = [t for t in st.required_lookups if t.startswith("elu")]
    assert len(elu) == 2 and elu[0] != elu[1]
    assert {t.split("_")[0] for t in stored} >= {"elu1.0", "elu0.5"}


def test_table_cache_writes_through_a_per_process_temporary(tmp_path, monkeypatch):
    monkeypatch.setenv("EZKL_TPU_CACHE", str(tmp_path))
    monkeypatch.delenv("EZKL_TPU_NO_TABLE_CACHE", raising=False)
    saved = []
    real_save = np.save
    monkeypatch.setattr(np, "save", lambda f, a, **kw: (saved.append(pathlib.Path(f).name),
                                                        real_save(f, a, **kw)))
    ys = np.arange(1 << 16, dtype=np.int64)
    ops._table_cache_store("t_si2_so2", ys)
    import os
    assert saved == [f".t_si2_so2.{os.getpid()}.tmp.npy"]
    np.testing.assert_array_equal(ops._table_cache_load("t_si2_so2", ys.size), ys)
    assert sorted(p.name for p in (tmp_path / "tables").iterdir()) == ["t_si2_so2.npy"]


def test_chunk_ctx_evaluates_as_the_whole_domain():
    """`evaluator.ChunkCtx` (the MockProver's path above 2^17 rows): a gate
    with rotations, evaluated chunk by chunk with wraparound gathers, equals
    the whole-domain evaluation."""
    from ezkl_tpu_torch.fieldmath import limbs
    from ezkl_tpu_torch.plonk import cs as csmod
    from ezkl_tpu_torch.plonk.evaluator import ChunkCtx, EvalCtx, evaluate
    system = csmod.ConstraintSystem()
    a, b = system.advice_column(), system.advice_column()
    poly = system.query(a, -1) * system.query(b, 1) + system.query(a) * 7 - 3
    rng = np.random.default_rng(5)
    n, size = 64, 16
    cols = {csmod.ADVICE: limbs.to_device(limbs.encode(
        mock.FR, rng.integers(0, 1 << 62, (2, n)).tolist()), "cpu").movedim(1, 0)}
    whole = evaluate(poly, EvalCtx(columns=cols, rot_step=1, challenges={}))
    chunks = [evaluate(poly, ChunkCtx(columns=cols, rot_step=1, challenges={},
                                      start=s, size=size, n=n))
              for s in range(0, n, size)]
    assert torch.cat(chunks, dim=1).equal(whole)


def test_conv2d_mnist_is_the_graded_model(tmp_path):
    """`chip_smoke.conv2d_mnist` (the model the card proves at k = 20)
    writes the bytes and input of `examples/gen_graded.py`'s conv2d_mnist,
    and its float64 forward (`conv2d_mnist_float`) is the JAX package's
    float forward of that file."""
    import chip_smoke
    sys.path.insert(0, str(ROOT / "examples"))
    import gen_graded
    gen_graded.gen_conv2d_mnist(tmp_path)
    onnx, inp = chip_smoke.conv2d_mnist(onnx_writer)
    assert onnx == (tmp_path / "conv2d_mnist.onnx").read_bytes()
    assert json.dumps(inp) == (tmp_path / "conv2d_mnist_input.json").read_text()
    assert chip_smoke.conv2d_mnist(ref_writer)[0] == onnx


@pytest.fixture(scope="module")
def conv2d(tmp_path_factory):
    """conv2d_mnist's files in both packages: settings.json at the default
    run arguments (kept as settings_default.json), then with logrows = 20
    (`chip_smoke.with_logrows`), model.compiled and witness.json."""
    import chip_smoke
    from ezkl_tpu.graph.circuit import GraphSettings as RefSettings
    from ezkl_tpu_torch.graph.circuit import GraphSettings

    base = tmp_path_factory.mktemp("conv2d_mnist")
    out = []
    for package_api, writer, settings_cls, name in (
            (ref_api, ref_writer, RefSettings, "ref"), (api, onnx_writer, GraphSettings, "port")):
        d = base / name
        d.mkdir()
        onnx, inp = chip_smoke.conv2d_mnist(writer)
        (d / "network.onnx").write_bytes(onnx)
        (d / "input.json").write_text(json.dumps(inp))
        package_api.gen_settings(d / "network.onnx", d / "settings.json")
        (d / "settings_default.json").write_bytes((d / "settings.json").read_bytes())
        chip_smoke.with_logrows(d / "settings.json", 20, settings_cls)
        package_api.compile_circuit(d / "network.onnx", d / "settings.json",
                                    d / "model.compiled")
        kw = {"device": "cpu"} if name == "port" else {}
        package_api.gen_witness(d / "model.compiled", d / "input.json", d / "witness.json",
                                **kw)
        out.append(d)
    return out


@pytest.mark.parametrize("artifact", ["settings_default.json", "settings.json",
                                      "model.compiled", "witness.json"])
def test_conv2d_mnist_files_byte_equal_the_reference(conv2d, artifact):
    """At the default run arguments the settings settle on k = 15; at
    logrows = 20 the compiled circuit and the witness (outputs within 0.5
    of the float64 forward, the same argmax) are the JAX package's bytes."""
    import chip_smoke
    ref, port = conv2d
    assert (port / artifact).read_bytes() == (ref / artifact).read_bytes()
    if artifact == "settings_default.json":
        assert json.loads((port / artifact).read_text())["run_args"]["logrows"] == 15
    if artifact == "settings.json":
        assert json.loads((port / artifact).read_text())["run_args"]["logrows"] == 20
    if artifact == "witness.json":
        got = np.asarray(json.loads((port / artifact).read_text())
                         ["pretty_elements"]["rescaled_outputs"], np.float64).reshape(-1)
        want = chip_smoke.conv2d_mnist_float()
        assert np.max(np.abs(got - want)) <= 0.5 and np.argmax(got) == np.argmax(want)


# -- the families of recurrent, attention, dynamic-gather and committed-I/O
#    circuits

# the witness's rescaled outputs against the float64 forward of the same
# weights, at input scale 2 (a step of 0.25): the recurrent cells within
# 0.3 (measured: 0.21-0.27), the attention block, whose LayerNormalization
# divides by a standard deviation below 1, within 1.5 (measured: 1.25) and
# 0.35 on average (0.26)
FLOAT_TOL = {"lstm_bidi": 0.3, "gru_bidi": 0.3, "rnn_bidi": 0.3, "attn_small": 1.5}


@pytest.mark.parametrize("name", sorted(FLOAT_TOL))
def test_outputs_within_tolerance_of_the_float64_forward(files, name, tmp_path):
    _, port = files(name)
    wit = api.gen_witness(port / "model.compiled", port / "input.json",
                          tmp_path / "witness.json", device="cpu")
    got = np.asarray(wit["pretty_elements"]["rescaled_outputs"][0], np.float64).reshape(-1)
    want = models.FLOAT_FORWARDS[name]().reshape(-1)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= FLOAT_TOL[name]
    if name == "attn_small":
        assert np.mean(np.abs(got - want)) <= 0.35


# torch.nn's gate order -> ONNX's: LSTM ifgo -> iofc, GRU rzn -> zrh
_TORCH_GATES = {"LSTM": [0, 2, 3, 1], "GRU": [1, 0, 2], "RNN": [0]}


@pytest.mark.parametrize("cell", [models.LSTM_CELL, models.GRU_CELL, models.RNN_CELL],
                         ids=lambda c: c["kind"])
def test_float64_forward_of_the_cells_is_torch_nn(cell):
    """`recurrent_float` (the ONNX definitions) is torch.nn's bidirectional
    cell on the same weights, to float64 rounding."""
    kind, i, h, steps = cell["kind"], cell["inputs"], cell["hidden"], cell["steps"]
    W, R, B, x = models._recurrent_draws(kind, i, h, steps, cell["seed"])
    net = getattr(torch.nn, kind)(i, h, bidirectional=True).double()
    order, g = _TORCH_GATES[kind], len(_TORCH_GATES[kind])
    with torch.no_grad():
        for d, suffix in enumerate(("", "_reverse")):
            for name, arr in (("weight_ih", W[d]), ("weight_hh", R[d]),
                              ("bias_ih", B[d, :g * h]), ("bias_hh", B[d, g * h:])):
                rows = torch.tensor(np.asarray(arr, np.float64).reshape(g, h, -1)[order])
                getattr(net, f"{name}_l0{suffix}").copy_(rows.reshape(getattr(
                    net, f"{name}_l0{suffix}").shape))
        y = net(torch.tensor(x))[0].numpy().reshape(steps, 1, 2, h).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(models.recurrent_float(**cell), y, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["attn_small", "bmm_einsum"])
def test_witness_products_take_the_freivalds_route(files, name):
    """q k^T and p v (and the einsum's batched product) are checked by
    Freivalds' argument: a challenge and second-phase advice, in both
    packages alike."""
    (ref_gc, ref_cfg, _), (gc, cfg, asg) = _assignments(files, name)
    assert cfg.cs.num_challenges == ref_cfg.cs.num_challenges >= 1
    assert asg.phase_callback is not None
    assert any(p != 0 for p in cfg.cs.advice_phase)
    assert list(cfg.cs.advice_phase) == list(ref_cfg.cs.advice_phase)


def _gather_lookup(cfg):
    lk = [lk for lk in cfg.cs.lookups if lk.name.startswith("dyn_gather")]
    assert len(lk) == 1
    return lk[0]


def test_dynamic_gather_looks_up_an_advice_table(files):
    """gather_dyn's Gather takes the dynamic-lookup argument: its table
    expression queries an advice column, and a gathered value moved by one
    fails the port's MockProver on that lookup."""
    (_, ref_cfg, _), (gc, cfg, asg) = _assignments(files, "gather_dyn")
    lk = _gather_lookup(cfg)
    assert any(q.column.kind == ADVICE for t in lk.table for q in t.queries())
    assert [x.name for x in cfg.cs.lookups] == [x.name for x in ref_cfg.cs.lookups]
    assert mock.verify(asg, None, device="cpu") == []
    row, col = models.gathered_cell(asg, cfg)
    asg.set_ints_at(col, [row], [asg.get_int(col, row) + 1])
    fails = _failures(mock.verify(asg, None, device="cpu"))
    assert [f[:2] for f in fails if f[0] == "lookup"] == [["lookup", lk.name]]


@pytest.mark.parametrize("part", [0, 1])
def test_split_parts_are_what_split_model_writes(tmp_path, part):
    """`mlp_4d_split_<part>` is the file that either package's
    `split_model(..., parts=2)` writes for mlp_4d."""
    onnx, inp = models.mlp_4d(onnx_writer)
    (tmp_path / "mlp_4d.onnx").write_bytes(onnx)
    (tmp_path / "input.json").write_text(json.dumps(inp))
    want = models.MODELS[f"mlp_4d_split_{part}"].build(onnx_writer)[0]
    for package_api in (api, ref_api):
        parts = package_api.split_model(str(tmp_path / "mlp_4d.onnx"),
                                        str(tmp_path / "input.json"), parts=2)
        assert pathlib.Path(parts[part][0]).read_bytes() == want


# `tests/test_visibility.py`'s matrix (input, output, param), on mlp_4d
VISIBILITY = [
    ("private", "public", "fixed"), ("public", "public", "fixed"),
    ("hashed", "public", "fixed"), ("kzgcommit", "public", "fixed"),
    ("private", "hashed", "fixed"), ("private", "kzgcommit", "fixed"),
    ("private", "public", "hashed"), ("private", "public", "kzgcommit"),
    ("hashed", "hashed", "hashed"), ("kzgcommit", "kzgcommit", "kzgcommit"),
    ("public", "private", "fixed"),
]


@pytest.mark.parametrize("iv,ov,pv", VISIBILITY)
def test_visibility_matrix_on_mlp_4d(tmp_path, iv, ov, pv):
    """The polycommit columns: as many as the JAX package lays out, each
    unblinded; the port's MockProver passes."""
    onnx, inp = models.mlp_4d(onnx_writer)
    (tmp_path / "m.onnx").write_bytes(onnx)
    (tmp_path / "input.json").write_text(json.dumps(inp))
    counts = []
    for package_api, ra_cls in ((ref_api, RefRunArgs), (api, RunArgs)):
        ra = ra_cls(**dict(models.MODELS["mlp_4d"].run_args, input_visibility=iv,
                           output_visibility=ov, param_visibility=pv)).validate()
        st = package_api.gen_settings(tmp_path / "m.onnx", tmp_path / "settings.json", ra)
        package_api.compile_circuit(tmp_path / "m.onnx", tmp_path / "settings.json",
                                    tmp_path / "model.compiled")
        gc = package_api.load_compiled(tmp_path / "model.compiled")
        arrays = package_api._reshape_for(
            gc, package_api._load_input(tmp_path / "input.json", gc.model.input_scales()))
        cfg, ctx, outputs = gc.forward(arrays)
        counts.append(len(cfg.polycommit_cols))
    expected = ((iv == "kzgcommit") + (ov == "kzgcommit") * len(outputs)
                + (pv == "kzgcommit") * len(ctx._param_tvals))
    assert counts[1] == counts[0] == expected
    assert all(cfg.cs.advice_unblinded[col.index] for col in cfg.polycommit_cols)
    assert gc.mock_prove(arrays, device="cpu") == []


def test_split_model_of_a_conv_model_raises_in_both_packages(tmp_path):
    """A gap of the reference kept in the port: `split_model` sizes the cut
    tensors by `forward_float`, which has no Conv in either package, so it
    refuses conv2d_mnist alike."""
    import chip_smoke
    onnx, inp = chip_smoke.conv2d_mnist(onnx_writer)
    (tmp_path / "conv.onnx").write_bytes(onnx)
    (tmp_path / "input.json").write_text(json.dumps(inp))
    for package_api in (api, ref_api):
        with pytest.raises(NotImplementedError, match="float forward: op Conv"):
            package_api.split_model(str(tmp_path / "conv.onnx"), str(tmp_path / "input.json"),
                                    parts=2)

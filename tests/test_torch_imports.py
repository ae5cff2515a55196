"""Guards of the PyTorch/CUDA port (`ezkl_tpu_torch`):

* neither the package (its EVM `evm/` and its mesh `parallel/` included)
  nor its card scripts (`chip_smoke.py`,
  `tools/profile_torch_prove.py`, `tools/bench_msm_kernels.py`,
  `tools/pair_k1_k9.py`, `tools/run_chip_phases.py`), nor the model
  constructors that `chip_smoke.py`'s families phase imports
  (`tests/torch_port_graph_models.py`), import
  `jax` or the JAX package `ezkl_tpu` (checked on the source with `ast`,
  and for the API, the CLI, the EVM and the mesh also in a fresh
  interpreter);
* every kernel wrapper (K1 mont_mul in each broadcast form and its chain
  forms mont_pow and mont_scan, K2 ntt_stages and its one-stage entry bfly,
  K3 point_add at each team size and its tree form point_reduce, K9
  point_dbl at each team size, and the fused MSM's K4
  scan_packed, K5 scan_steps and K6 fold_lanes in both variants, K6 and K7
  dbl_pow2 also at each team size, K8 horner) raises when its kernel
  cannot be built, instead of
  falling back to the plain version; and a tensor on the card always takes
  the kernel route;
* on the card a Fermat inversion is one launch and a batch inversion runs
  its scan blocks as single launches, not one per product; a transform is
  one K2 launch per pass, not per stage; the halving tree of
  `reduce_pairwise` is one launch; K3's single add, K6, K7 and K9 pick
  their team by width, K1 passes its broadcast operand's period and
  repeat, and every K1-K9 launch records its width (`build.WIDTHS`).

No card is needed: the build is mocked, or replaced by a library that
records its calls.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from ezkl_tpu_torch.fieldmath import curve, limbs
from ezkl_tpu_torch.fieldmath.spec import bn254_fr
from ezkl_tpu_torch.kernels import build, msm, ntt, pcurve, pntt

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "ezkl_tpu")
FR = bn254_fr()
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _sources():
    files = sorted((ROOT / "ezkl_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_prove.py",
        ROOT / "tools" / "bench_msm_kernels.py", ROOT / "tools" / "pair_k1_k9.py",
        ROOT / "tools" / "run_chip_phases.py", ROOT / "tests" / "torch_port_graph_models.py"]
    assert len(files) > 10
    return files


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_chip_smoke_defines_each_top_level_name_once():
    """`chip_smoke.py` is one long module of phases: a helper that a later
    phase defines again under an earlier one's name replaces it for every
    phase."""
    import collections
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = collections.Counter(
        [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
        + [t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets
           if isinstance(t, ast.Name)])
    assert [name for name, count in names.items() if count > 1] == []


def test_scan_covers_the_evm_and_the_mesh():
    names = {str(p.relative_to(ROOT)) for p in _sources()}
    for sub in ("evm/__init__.py", "evm/vm.py", "evm/solidity.py", "evm/bytecode.py",
                "parallel/__init__.py", "parallel/sharded.py"):
        assert f"ezkl_tpu_torch/{sub}" in names


def test_api_and_cli_import_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, importing the port's API, CLI, EVM and mesh
    leaves no `jax` or `ezkl_tpu` module behind (catches imports inside
    functions that run at import time, which the scan above cannot see)."""
    import subprocess
    import sys
    code = ("import sys, ezkl_tpu_torch.api, ezkl_tpu_torch.__main__, "
            "ezkl_tpu_torch.evm.vm, ezkl_tpu_torch.evm.bytecode, ezkl_tpu_torch.parallel; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ezkl_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_families_phase_imports_neither_jax_nor_the_jax_package():
    """`chip_smoke.py`'s families phase loads the model constructors of
    `tests/torch_port_graph_models.py` and builds every model with the
    port's writer, each card model's input and float64 forward too, in a
    fresh interpreter: no `jax` or `ezkl_tpu` module is left behind."""
    import subprocess
    import sys
    code = ("import sys, chip_smoke\n"
            "from ezkl_tpu_torch.graph import onnx_writer as w\n"
            "m = chip_smoke.graph_models()\n"
            "for name in list(m.MODELS) + list(m.CARD_MODELS):\n"
            "    m.MODELS.get(name, m.CARD_MODELS.get(name)).build(w)\n"
            "for name in chip_smoke.FAMILY_CARD:\n"
            "    m.FLOAT_FORWARDS[name]()\n"
            "print(sorted(x for x in sys.modules if x.split('.')[0] in ('jax', 'ezkl_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _no_nvcc(*args, **kwargs):
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _field(n=4):
    return limbs.to_device(limbs.encode(FR, list(range(1, n + 1))), "cpu")


def _points(n=4):
    return curve.generator((n,), "cpu")


def _grid(*shape):
    """Points of batch `shape`: (S, m) step-major scans, (G, n) folds,
    (W, width) Horner windows."""
    return curve.generator(shape, "cpu")


def _signs(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _msm_call():
    pts = _points(16)
    scalars = limbs.to_device(limbs.encode(FR, [list(range(1, 17))], mont=False), "cpu")
    return msm.msm_multi(pts, scalars.movedim(1, 0), c=3, affine=True)


KERNEL_CALLS = {
    "mont_mul": lambda: limbs._mont_mul_kernel(FR, _field(), _field()),
    "mont_pow": lambda: limbs._mont_pow_kernel(FR, _field(), FR.modulus - 2),
    "mont_scan": lambda: limbs._mont_scan_kernel(FR, _field(32)),
    "bfly": lambda: pntt._stages_kernel(FR, _field(), _field(1), 1, 0, 1),
    "ntt_stages": lambda: pntt._stages_kernel(FR, _field(16), _field(8), 4, 1, 3),
    "point_add": lambda: pcurve._add_launch((*_points(), *_points()), 2),
    "point_add_team8": lambda: pcurve._add_launch((*_points(), *_points()), 8),
    "point_reduce": lambda: pcurve._reduce_kernel(_grid(3, 8)),
    "point_dbl": lambda: pcurve._dbl_launch(tuple(_points()), pcurve.dbl_team(4)),
    **{f"point_dbl_team{t}": (lambda t=t: pcurve._dbl_launch(tuple(_points()), t))
       for t in pcurve.DBL_TEAMS},
    **{f"mont_mul_{form}": (lambda a=a, b=b, bs=bs: limbs._mont_mul_kernel(
        FR, _field(a).reshape(8, 2, -1), _field(b).reshape(8, *bs)))
       for form, a, b, bs in (("constant", 16, 1, (1, 1)), ("row", 16, 8, (1, 8)),
                              ("per_row", 16, 2, (2, 1)))},
    "scan_packed": lambda: pcurve._scan_packed_kernel(_grid(2, 4).x, _grid(2, 4).y, _signs(2, 4)),
    "scan_steps_complete": lambda: pcurve._scan_steps_kernel(_grid(2, 4)),
    "scan_steps_mixed": lambda: pcurve._scan_steps_kernel(tuple(_grid(2, 4))[:2]),
    "fold_lanes_complete": lambda: pcurve._fold_lanes_kernel(_grid(2, 256), 128),
    "fold_lanes_mixed": lambda: pcurve._fold_lanes_kernel(tuple(_grid(2, 256))[:2], 128),
    "dbl_pow2": lambda: pcurve._dbl_pow2_kernel(_points(), 3),
    "horner": lambda: pcurve._horner_kernel(_grid(3, 2), 3),
    **{f"fold_lanes_{v}_team{t}": (lambda v=v, t=t: pcurve._fold_lanes_launch(
        _grid(2, 256) if v == "complete" else tuple(_grid(2, 256))[:2], 128, t))
       for v in ("complete", "mixed") for t in pcurve.SCAN_TEAMS},
}

PUBLIC_CALLS = {
    "mont_mul": lambda: limbs.mont_mul(FR, _field(), _field()),
    "mont_pow": lambda: limbs.inv(FR, _field()),
    "mont_scan": lambda: limbs.prefix_scan_mul(FR, _field(40)),
    "bfly": lambda: pntt.bfly(FR, _field(), _field(1)),
    "ntt": lambda: ntt.ntt(FR, _field(16)),
    "point_add": lambda: curve.add(_points(), _points()),
    "reduce_pairwise": lambda: pcurve.reduce_pairwise(_grid(3, 8)),
    "point_dbl": lambda: curve.dbl(_points()),
    "scan_packed": lambda: pcurve.prefix_scan_packed(_grid(4, 2).x, _grid(4, 2).y, _signs(4, 2)),
    "scan_steps_complete": lambda: pcurve.prefix_scan_steps(_grid(4, 2)),
    "scan_steps_mixed": lambda: pcurve.prefix_scan_steps(tuple(_grid(4, 2))[:2]),
    "fold_lanes_complete": lambda: pcurve.fold_lanes(_grid(2, 256), blk=128),
    "fold_lanes_mixed": lambda: pcurve.fold_lanes(tuple(_grid(2, 256))[:2], blk=128),
    "dbl_pow2": lambda: pcurve.dbl_pow2(_points(), 3),
    "horner": lambda: pcurve.horner_combine(_grid(3, 2), 3),
    "msm_multi": _msm_call,
}


@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_kernel_route_raises_when_the_build_fails(monkeypatch, name):
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", _no_nvcc)
    before, widths = dict(build.LAUNCHES), list(build.WIDTHS)
    with pytest.raises(RuntimeError, match="nvcc"):
        KERNEL_CALLS[name]()
    assert build.LAUNCHES == before
    assert list(build.WIDTHS) == widths


@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_kernel_route_refuses_host_tensors(monkeypatch, name):
    """With a library loaded, the kernel route still refuses CPU tensors
    rather than computing anything itself."""
    monkeypatch.setattr(build, "_LIB", object())
    with pytest.raises(ValueError, match="CUDA device"):
        KERNEL_CALLS[name]()


@pytest.mark.parametrize("name", sorted(PUBLIC_CALLS))
def test_card_tensors_take_the_kernel_route(monkeypatch, name):
    """The public entry points dispatch on the tensor's device alone: a
    tensor on the card reaches the (here unbuildable) kernel, never the
    plain version."""
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", _no_nvcc)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(RuntimeError, match="nvcc"):
        PUBLIC_CALLS[name]()


class _RecordingLib:
    """A kernel library that launches nothing and records each entry called."""

    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            self.args.append(args)
            return 0
        return entry


@pytest.fixture
def card(monkeypatch):
    """CPU tensors that pass for card tensors, and a recording library."""
    lib = _RecordingLib()
    monkeypatch.setattr(build, "_LIB", lib)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    # tables built here hold the recording library's outputs: keep them
    # out of the module's cache
    monkeypatch.setattr(ntt, "_DEV_MEMO", {})
    build.reset_launches()
    yield lib
    build.reset_launches()


def test_inv_on_the_card_is_one_launch(card):
    """A Fermat inversion (a^(p-2): 309 products in Fr by the sliding window)
    is one `mont_pow` launch, whatever the width."""
    for n in (1, 8, 64):
        card.calls.clear()
        limbs.inv(FR, _field(n))
        assert card.calls == ["ez_mont_pow"]
    assert build.LAUNCHES["mont_pow"] == 3
    assert sum(build.LAUNCHES.values()) == 3
    assert [w[:3] for w in build.WIDTHS] == [("mont_pow", "bn254_fr", n) for n in (1, 8, 64)]
    assert build.WIDTHS[0][3] == 8 + 252 + 49         # table, squarings, windows


def test_batch_inv_on_the_card_scans_in_blocks(card):
    """`batch_inv` of 64 elements: each of its two scans is one `mont_scan`
    per 32-step block level (local blocks, then their totals) and one
    combine, then one `mont_pow` and two products -- 9 launches, where a
    launch per product took over 500."""
    limbs.batch_inv(FR, _field(64))
    assert build.LAUNCHES["mont_scan"] == 4
    assert build.LAUNCHES["mont_pow"] == 1
    assert build.LAUNCHES["mont_mul"] == 4
    assert sum(build.LAUNCHES.values()) == 9
    assert [w[2:] for w in build.WIDTHS if w[0] == "mont_scan"] == [(64, 62), (2, 1)] * 2


def test_cuh_constants_match_the_field_specs():
    """The moduli, 2p and -p^-1 mod 2^32 written into bn254.cuh."""
    import re
    from ezkl_tpu_torch.fieldmath.spec import bn254_fq
    text = (ROOT / "ezkl_tpu_torch" / "csrc" / "bn254.cuh").read_text()
    for struct, spec in (("Fr", FR), ("Fq", bn254_fq())):
        body = text[text.index(f"struct {struct} {{"):]
        body = body[:body.index("\n};")]
        inv = int(re.search(r"INV = (0x[0-9a-f]+)u", body).group(1), 16)
        arrays = re.findall(r"\{([0-9a-fx, u\n]+)\}", body)
        words = [[int(w, 16) for w in re.findall(r"0x[0-9a-f]+", a)] for a in arrays]
        value = lambda ws: sum(w << (32 * i) for i, w in enumerate(ws))  # noqa: E731
        assert value(words[0]) == spec.modulus
        assert value(words[1]) == 2 * spec.modulus
        assert (inv * spec.modulus) % (1 << 32) == (1 << 32) - 1
        if len(words) > 2:                                   # Montgomery one, R mod p
            assert value(words[2]) == (1 << 256) % spec.modulus


def test_width_histogram_counts_launches_per_field_and_power_of_two():
    """`build.width_histogram`: K1-K3 launches by kernel, field and the least
    power of two >= the launch's element count."""
    widths = [("mont_mul", "bn254_fr", 16384), ("mont_mul", "bn254_fr", 16377),
              ("mont_mul", "bn254_fq", 1), ("bfly", "bn254_fr", 131072),
              ("mont_mul", "bn254_fr", 3)]
    assert build.width_histogram(widths) == {
        "bfly/bn254_fr": {"2^17": 1},
        "mont_mul/bn254_fq": {"2^0": 1},
        "mont_mul/bn254_fr": {"2^2": 1, "2^14": 2}}


@pytest.mark.parametrize("k", [1, 10, 11, 14, 17])
def test_ntt_on_the_card_is_one_launch_per_pass(card, k):
    """A transform of 2^k points over a batch is one `ez_ntt_stages` launch
    per pass of `pass_split(k)` (k = 14: 2, where one launch per stage took
    14), each with the pass's (s0, r), groups per block and 2^k columns. (The
    first transform of a size also builds its twiddle table, k - 1 K1
    launches, `limbs.powers`; it is built first here.)"""
    x = limbs.zeros((2, 1 << k), "cpu")
    ntt.twiddles(FR, k, False, x.device)
    assert card.calls == ["ez_mont_mul"] * (k - 1)
    card.calls.clear()
    card.args.clear()
    build.reset_launches()
    ntt.ntt(FR, x)
    split = pntt.pass_split(k)
    assert card.calls == ["ez_ntt_stages"] * len(split)
    assert build.LAUNCHES["ntt_stages"] == len(split) == -(-k // 10)
    for args, (s0, r) in zip(card.args, split):
        assert args[4:9] == (2, k, s0, r, pntt.groups_per_block(2, k, s0, r))
    assert [w[:3] for w in build.WIDTHS] == [("ntt_stages", "bn254_fr", 2 << k)] * len(split)


def test_bfly_on_the_card_is_one_single_stage_pass(card):
    """`pntt.bfly` with a stage table of `half` entries is one pass of r = 1:
    stage log2(half) + 1 of a transform of 2 * half points over the blocks."""
    pntt.bfly(FR, _field(16), _field(4))
    assert card.calls == ["ez_ntt_stages"]
    assert card.args[0][4:8] == (2, 3, 2, 1)        # 2 blocks of 8, stage 3


@pytest.mark.parametrize("w, want", [(2, ["ez_point_reduce"]), (128, ["ez_point_reduce"]),
                                     (256, ["ez_point_reduce"]),
                                     (1024, ["ez_point_add", "ez_point_add",
                                             "ez_point_reduce"])])
def test_reduce_pairwise_on_the_card_is_one_tree_launch(card, w, want):
    """The halving tree of `reduce_pairwise` over (8, 3, w) partials is one
    `ez_point_reduce` launch up to 256 partials, after one halving add per
    level above; where each level was a K3 launch (7 at w = 128)."""
    pcurve.reduce_pairwise(_grid(3, w))
    assert card.calls == want
    assert card.args[-1][-3:-1] == (3, min(w, pcurve.TREE_MAX))
    assert build.LAUNCHES["point_reduce"] == 1


@pytest.mark.parametrize("n, team", [(26, 8), (4096, 8), (4097, 2), (106496, 2)])
def test_point_add_team_by_lanes(card, n, team):
    """K3's single add runs a team of 8 threads per lane up to 4,096 lanes
    and of 2 above, the sides of the H100 sweep (PERF.md)."""
    assert pcurve.point_add_team(n) == team
    p = curve.identity((n,), "cpu")
    curve.add(p, p)
    assert card.calls == ["ez_point_add"]
    assert card.args[0][-3:-1] == (n, team)


@pytest.mark.parametrize("a_shape, b_shape, period, rep", [
    ((8, 3, 16), (8, 3, 16), 48, 1),      # dense
    ((8, 3, 16), (8, 1, 1), 1, 1),        # a constant
    ((8, 3, 16), (8, 1, 16), 16, 1),      # a row
    ((8, 6, 5), (8, 1, 5), 5, 1),         # a row of 5
    ((8, 3, 16), (8, 3, 1), 3, 16),       # one value per row
    ((8, 6, 5), (8, 6, 1), 6, 5),         # one per row of 5
    ((8, 2, 3, 4), (8, 1, 3, 1), 3, 4),   # a run of middle dims
    ((8, 3, 5), (8, 3, 5), 15, 1),        # n = 15
    ((8, 1), (8, 1), 1, 1),               # n = 1
])
def test_mont_mul_on_the_card_passes_form_and_magic(card, a_shape, b_shape, period, rep):
    """One `ez_mont_mul` launch per product, either operand side, given b's
    (period, repeat) from `bcast_form`; its entry picks the form and the
    divisors' magic from them (`csrc/bcast.cuh`)."""
    n = int(np.prod(torch.broadcast_shapes(a_shape, b_shape)[1:]))
    a = limbs.zeros(a_shape[1:], "cpu")
    b = limbs.zeros(b_shape[1:], "cpu")
    for lhs, rhs in ((a, b), (b, a)):
        limbs._mont_mul_kernel(FR, lhs, rhs)
    assert card.calls == ["ez_mont_mul"] * 2
    for args in card.args:
        assert len(args) == 8 and args[4:7] == (n, period, rep)
    assert list(build.WIDTHS) == [("mont_mul", "bn254_fr", n, n)] * 2


@pytest.mark.parametrize("n, team", [(1, 4), (26, 4), (1000, 4), (1 << 13, 4),
                                     ((1 << 13) + 1, 2), (1 << 14, 2), (1 << 17, 2)])
def test_point_dbl_team_by_lanes(card, n, team):
    """K9 on the card: one `ez_point_dbl` launch with the team `dbl_team`
    picks -- 4 threads per lane up to 2^13 lanes (the unfused MSM's 1 and
    26), 2 above (`gen_srs` at k = 14 and more), the sides of the H100 sweep
    (PERF.md) -- recorded in `build.WIDTHS` as (kernel, field, lanes, 8
    products a lane)."""
    assert pcurve.dbl_team(n) == team
    assert team in pcurve.DBL_TEAMS
    curve.dbl(curve.identity((n,), "cpu"))
    assert card.calls == ["ez_point_dbl"]
    assert card.args[0][-3:-1] == (n, team)
    assert list(build.WIDTHS) == [("point_dbl", "bn254_fq", n, 8 * n)]
    assert build.width_histogram() == {"point_dbl/bn254_fq": {f"2^{(n - 1).bit_length()}": 1}}


@pytest.mark.parametrize("groups, team", [(26, 8), (32, 8), (33, 2), (52, 2), (208, 2)])
def test_fold_lanes_team_by_lanes(card, groups, team):
    """K6 on the card over `groups` x 4 chunks of 128 lanes runs a team of 8
    threads per lane up to 4,096 lanes (one column at k = 14: 26 groups,
    3,328 lanes) and of 2 above (2-8 columns), the sides of the H100 sweep
    (PERF.md)."""
    assert pcurve.lane_team(groups * 128) == team
    pcurve.fold_lanes(_grid(groups, 512), blk=128)
    assert card.calls == ["ez_fold_lanes"]
    assert card.args[0][0] == 0                          # complete adds
    assert card.args[0][-5:-1] == (groups, 4, 128, team)


@pytest.mark.parametrize("n, c", [(26, 9), (52, 9), (104, 9), (208, 9), (1001, 1)])
def test_dbl_pow2_on_the_card_is_one_launch(card, n, c):
    """K7 on the card runs all c doublings of every lane in one launch: at
    the prove's 26-208 lanes with c = 9, and over 1,001 lanes with c = 1."""
    pcurve.dbl_pow2(_points(n), c)
    assert card.calls == ["ez_dbl_pow2"]
    assert card.args[0][-3:-1] == (n, c)
    assert build.LAUNCHES["dbl_pow2"] == 1


def _msm_kernel_calls():
    g = _grid(4, 3)                                      # (S, m) = (4, 3)
    return {
        "scan_packed": (lambda: pcurve.scan_packed_steps(g.x, g.y, _signs(4, 3)),
                        (3, 11 * 3 * 3, (2 * 32 + 4 + 96) * 4 * 3)),
        "scan_steps_complete": (lambda: pcurve.scan_steps(g), (3, 12 * 3 * 3, 192 * 4 * 3)),
        "scan_steps_mixed": (lambda: pcurve.scan_steps((g.x, g.y)), (3, 11 * 3 * 3, 160 * 4 * 3)),
        "fold_lanes_complete": (lambda: pcurve.fold_lanes(_grid(2, 256), blk=128),
                                (256, 12 * 256, (3 * 2 + 3) * 32 * 256)),
        "fold_lanes_mixed": (lambda: pcurve.fold_lanes(tuple(_grid(2, 256))[:2], blk=128),
                             (256, 11 * 256, (2 * 2 + 3) * 32 * 256)),
        "dbl_pow2": (lambda: pcurve.dbl_pow2(_points(5), 3), (5, 8 * 3 * 5, 192 * 5)),
        "horner": (lambda: pcurve.horner_combine(_grid(3, 2), 3),
                   (2, 3 * (8 * 3 + 12) * 2, 96 * 4 * 2)),
    }


@pytest.mark.parametrize("name", sorted(_msm_kernel_calls()))
def test_msm_kernel_launch_records_its_width(card, name):
    """Each K4-K8 launch records (kernel, field, lanes, products, bytes) in
    `build.WIDTHS`: lanes = point chains, products = the Montgomery products
    the kernel runs (11 per mixed add, 12 per complete add, 8 per doubling),
    bytes = each input read and each output written once; so the profile can
    report the fused MSM's launches by width and their bound."""
    call, want = _msm_kernel_calls()[name]
    call()
    kernel = name.replace("_complete", "").replace("_mixed", "")
    assert list(build.WIDTHS) == [(kernel, "bn254_fq", *want)]
    assert build.width_histogram() == {
        f"{kernel}/bn254_fq": {f"2^{(want[0] - 1).bit_length()}": 1}}


def test_profile_pairs_point_kernel_launches_with_device_events(monkeypatch):
    """`tools/profile_torch_prove.py` pairs the i-th K4-K8 launch of a kernel
    with the i-th device event of its name and sums device time and bound
    (from the launch's bytes and products) per width; its `top` lists device
    operations by total time, and past its first TOP those that `--match`
    names."""
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke
    import profile_torch_prove as prof

    widths = [("fold_lanes", "bn254_fq", 3328, 12 * 3 * 3328, 9 * 32 * 3328),
              ("dbl_pow2", "bn254_fq", 26, 8 * 9 * 26, 192 * 26),
              ("fold_lanes", "bn254_fq", 26624, 12 * 3 * 26624, 9 * 32 * 26624)]
    ops = [(10, 14000, "void (anonymous namespace)::fold_lanes_kernel<false, 8>(...)"),
           (20, 16000, "void (anonymous namespace)::dbl_pow2_kernel<4>(...)"),
           (30, 53000, "void (anonymous namespace)::fold_lanes_kernel<false, 2>(...)"),
           (40, 1000, "elementwise_kernel")]
    out = prof._widths(ops, widths)
    fold = out["fold_lanes/bn254_fq"]
    assert fold["2^12"]["launches"] == fold["2^15"]["launches"] == 1
    assert fold["2^12"]["device_ms"] == pytest.approx(0.014)
    assert fold["2^15"]["device_ms"] == pytest.approx(0.053)
    assert fold["2^12"]["bound_ms"] == pytest.approx(chip_smoke.bound(
        9 * 32 * 3328, chip_smoke.IMAD_PER_MONT_MUL * 12 * 3 * 3328)[0])
    dbl = out["dbl_pow2/bn254_fq"]["2^5"]
    assert dbl["gap_ms"] == pytest.approx(dbl["device_ms"] - dbl["bound_ms"])
    assert not any(k.endswith("_unpaired") for k in out)
    ops.append((50, 2000, "elementwise_kernel"))
    monkeypatch.setattr(prof, "TOP", 1)
    assert prof._top(ops, r"fold_lanes|dbl_pow2") == [
        {"name": ops[2][2], "count": 1, "total_ms": pytest.approx(0.053)},
        {"name": ops[1][2], "count": 1, "total_ms": pytest.approx(0.016)},
        {"name": ops[0][2], "count": 1, "total_ms": pytest.approx(0.014)}]
    assert [t["name"] for t in prof._top(ops)] == [ops[2][2]]


def test_profile_pairs_k1_and_k9_launches_with_their_template_names():
    """`tools/profile_torch_prove.py` pairs K1 launches with the device events
    of `mont_mul_kernel<form, field>` (the field checked from the name) and
    K9's with `point_dbl_kernel<team>`, with K9's bound from 192 bytes and 8
    products a lane."""
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke
    import profile_torch_prove as prof

    n = 1 << 14
    widths = [("mont_mul", "bn254_fr", n, n), ("point_dbl", "bn254_fq", n, 8 * n),
              ("mont_mul", "bn254_fq", 8, 8)]
    ops = [(10, 3000, "void (anonymous namespace)::mont_mul_kernel<1, bn254::Fr>(...)"),
           (20, 7000, "void (anonymous namespace)::point_dbl_kernel<2>(...)"),
           (30, 2000, "void (anonymous namespace)::mont_mul_kernel<0, bn254::Fq>(...)")]
    out = prof._widths(ops, widths)
    assert not any(k.endswith("_unpaired") for k in out)
    assert out["mont_mul/bn254_fr"]["2^14"]["device_ms"] == pytest.approx(0.003)
    assert out["mont_mul/bn254_fq"]["2^3"]["device_ms"] == pytest.approx(0.002)
    dbl = out["point_dbl/bn254_fq"]["2^14"]
    assert dbl["device_ms"] == pytest.approx(0.007)
    assert dbl["bound_ms"] == pytest.approx(chip_smoke.bound(
        192 * n, chip_smoke.IMAD_PER_MONT_MUL * 8 * n)[0])
    swapped = [ops[0][:2] + (ops[2][2],), ops[1], ops[2][:2] + (ops[0][2],)]
    assert "mont_mul_unpaired" in prof._widths(swapped, widths)

"""The port's fused MSM (`ezkl_tpu_torch.kernels.msm.msm_multi`) and the plain
versions of its kernels K4-K8 (`ezkl_tpu_torch.kernels.pcurve`) on the CPU:

* bit-exact (projective words) against the JAX package's fused kernels and
  `_prefix_points_fused` / `_msm_multi_fused`, run in Pallas interpret mode
  by `tools/make_torch_fixtures.py` on the inputs of
  `torch_port_circuits.fused_cases` and frozen into
  `tests/fixtures/torch_port/fused_*.json`;
* `curve.add_mixed` and the grouped plain mixed add bit-exact against
  `ezkl_tpu.fieldmath.curve.add_mixed`, run live;
* the fused MSM affine-equal to the host oracle `hostcurve.g1_msm`, in the
  cases of `tests/test_pallas_interpret.py:45-77` and more.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from ezkl_tpu.fieldmath import curve as ref_curve
from ezkl_tpu_torch import convert
from ezkl_tpu_torch.fieldmath import curve, hostcurve, limbs
from ezkl_tpu_torch.fieldmath.curve import PointP
from ezkl_tpu_torch.fieldmath.spec import bn254_fq, bn254_fr
from ezkl_tpu_torch.kernels import msm, pcurve

import torch_port_circuits as circuits

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
FQ, FR = bn254_fq(), bn254_fr()
CASES = circuits.fused_cases(hostcurve)
RNG = np.random.default_rng(91)
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _enc(vals, spec=FQ, mont=True):
    return limbs.to_device(limbs.encode(spec, vals.tolist(), mont=mont), "cpu")


def _run_case(case):
    coords = [_enc(v) for v in case["p" if "p" in case else "xy"]]
    pt = PointP(*coords) if len(coords) == 3 else tuple(coords)
    kind = case["kind"]
    if kind == "scan_packed":
        return pcurve.prefix_scan_packed(*coords, torch.from_numpy(case["sn"].astype(np.int32)))
    if kind == "scan_steps":
        return pcurve.prefix_scan_steps(pt)
    if kind == "fold_lanes":
        return pcurve.fold_lanes(pt, blk=case["blk"])
    if kind == "dbl_pow2":
        return pcurve.dbl_pow2(pt, case["c"])
    if kind == "horner":
        return pcurve.horner_combine(pt, case["c"])
    if kind == "prefix_points_fused":
        return msm._prefix_points_fused(pt)
    scalars = _enc(case["scalars"], FR, mont=False).movedim(1, 0)
    return msm.msm_multi(pt, scalars, c=case["c"], affine=case["affine"])


@pytest.mark.parametrize("name", sorted(set(CASES) - {"msm_fused_padded"}))
def test_plain_bit_exact_vs_jax_interpret(name):
    """K4 (signs mixed), K5 and K6 in both variants (the complete ones with
    identity lanes), K7 at c = 3 and 9, K8, the recursive block-total
    prefix (m = 64) and the whole fused MSM (n = 32, c = 4, C = 2, affine
    and projective inputs): the same projective words as the TPU kernels."""
    want = json.loads((FIXTURES / f"fused_{name}.json").read_text())
    got = _run_case(CASES[name])
    for c in "xyz":
        np.testing.assert_array_equal(limbs.host_words(getattr(got, c)),
                                      np.asarray(want[c], np.uint32), err_msg=f"{name}.{c}")


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("group", [1, 2, None])
def test_window_groups_give_the_frozen_words(affine, group):
    """The fixture MSM (C = 2 columns of W = 64 windows, c = 4) in groups of
    1 and 2 windows (64 and 32 groups a column) and at the default (one
    group of all 128 windows): the JAX package's words each time, which
    ran in groups of 32 windows."""
    name = f"msm_fused_{'affine' if affine else 'projective'}"
    case = CASES[name]
    want = json.loads((FIXTURES / f"fused_{name}.json").read_text())
    coords = [_enc(v) for v in case["p"]]
    scalars = _enc(case["scalars"], FR, mont=False).movedim(1, 0)
    got = msm.msm_multi(PointP(*coords), scalars, c=case["c"], affine=affine, group=group)
    for c in "xyz":
        np.testing.assert_array_equal(limbs.host_words(getattr(got, c)),
                                      np.asarray(want[c], np.uint32), err_msg=f"{group}.{c}")


@pytest.mark.parametrize("group, C", [(5, 2), (100, 4)])
def test_window_groups_that_pad_or_span_columns_match_host(group, C):
    """Groups of 5 windows pad each column's 26 windows (c = 10) with zero
    windows to 30; a group of 100 windows holds 3 whole columns (78
    windows), so the last group holds one column. The sums are the
    host's."""
    n = 64
    pts = _points(n)
    cols = [_scalars(n) for _ in range(C)]
    S = limbs.to_device(limbs.encode(FR, cols, mont=False), "cpu").movedim(1, 0)
    out = msm.msm_multi(curve.encode_points(pts, "cpu"), S, c=10, affine=True, group=group)
    assert curve.decode_points(out) == [hostcurve.g1_msm(pts, sc) for sc in cols]


@pytest.mark.parametrize("C, n, want", [
    (8, 1 << 14, 208),            # the k = 14 stand-in's widest commitment: one group
    (16, 1 << 14, 416),           # 16 columns of 26 windows at 2^14: 6.8M point-windows
    (32, 1 << 13, 832),           # mlp_4d's widest commitment at k = 13: one group
    (32, 1 << 17, 60),            # three whole columns of 20 windows (c = 13) a group
    (32, 1 << 20, 8),             # k = 20 keygen (31 fixed columns padded to 32): 64 groups
    (1, 1 << 20, 8),
    (1, 1 << 24, 1),
])
def test_window_group_budget(C, n, want):
    """Every commitment of the k = 14 stand-in and of mlp_4d's prove keeps
    one group of all C * W windows, as before groups; at 2^20 points a group
    is 8 of a column's 16 windows (c = 16), 2^23 point-windows."""
    W = len(msm._signed_windows(msm.default_window_bits(n)))
    G = msm.window_group(C, W, n)
    assert G == want
    assert G * n <= msm.GROUP_POINTS or G == 1


def _points(n):
    return [hostcurve.g1_mul(hostcurve.G1, int(k)) for k in RNG.integers(1, 1 << 30, size=n)]


def _scalars(n):
    return [int.from_bytes(RNG.bytes(32), "little") % FR.modulus for _ in range(n)]


def test_add_mixed_bit_exact_vs_reference():
    """`curve.add_mixed` (with and without identity lanes on either side)
    and the grouped `pcurve._mixed_add_w` against the JAX package's
    `curve.add_mixed`."""
    import jax.numpy as jnp
    pts = _points(6)
    P = curve.encode_points([None] + pts[1:], "cpu")       # lane 0: identity + Q
    q = pts[::-1]
    qx, qy = (_enc(np.asarray([p[i] for p in q], dtype=object)) for i in range(2))
    q_inf = torch.tensor([False, False, True, False, True, False])
    ref_p = convert.limbs_to_ref
    want = ref_curve.add_mixed(ref_curve.PointP(*(jnp.asarray(ref_p(c)) for c in P)),
                               jnp.asarray(ref_p(qx)), jnp.asarray(ref_p(qy)),
                               jnp.asarray(q_inf.numpy()))
    got = curve.add_mixed(P, qx, qy, q_inf)
    grouped = pcurve._mixed_add_w(*(limbs._w(c) for c in (*P, qx, qy)))
    plain = ref_curve.add_mixed(ref_curve.PointP(*(jnp.asarray(ref_p(c)) for c in P)),
                                jnp.asarray(ref_p(qx)), jnp.asarray(ref_p(qy)))
    for i, c in enumerate("xyz"):
        np.testing.assert_array_equal(limbs.host_words(getattr(got, c)),
                                      convert.words_from_ref(getattr(want, c)))
        np.testing.assert_array_equal(limbs.host_words(limbs._i32(grouped[i])),
                                      convert.words_from_ref(getattr(plain, c)))


def _msm(points, scalars, c, affine=True):
    P = curve.encode_points(points, "cpu")
    S = limbs.to_device(limbs.encode(FR, scalars, mont=False), "cpu")
    P, S = msm.pad_msm_inputs(P, S)
    out = msm.msm(P, S, c=c, affine=affine)
    return curve.decode_points(out.map(lambda a: a[..., None]))[0]


@pytest.mark.parametrize("affine", [True, False])
def test_fused_msm_matches_host_n32(affine):
    pts, sc = _points(32), _scalars(32)
    assert _msm(pts, sc, c=5, affine=affine) == hostcurve.g1_msm(pts, sc)


def test_fused_msm_identity_padded_lanes_affine():
    """n = 24 padded to 32 with (0:1:0) lanes, which reach K4 as the affine
    pair (0, 1): the reference's interpret-mode case."""
    pts, sc = _points(24), _scalars(24)
    assert _msm(pts, sc, c=4) == hostcurve.g1_msm(pts, sc)


def test_padded_affine_msm_is_right_where_the_reference_is_not():
    """The fixture case of 24 points padded to 32 with (0:1:0) lanes, affine
    pipeline: the JAX package's TPU kernels add the pad pair (0, 1) as a
    point, so its frozen sums miss the host MSM; the port's K4 reads the
    pair as the identity and hits it."""
    case = CASES["msm_fused_padded"]
    want = json.loads((FIXTURES / "fused_msm_fused_padded.json").read_text())
    ref = PointP(*(limbs.to_device(np.asarray(want[c], np.uint32), "cpu") for c in "xyz"))
    pts = [(int(x), int(y)) for x, y, z in zip(*case["p"]) if z]
    host = [hostcurve.g1_msm(pts, [int(v) for v in col[:len(pts)]]) for col in case["scalars"]]
    assert all(a != b for a, b in zip(curve.decode_points(ref), host))
    assert curve.decode_points(_run_case(case)) == host


def test_fused_msm_all_zero_scalars_is_identity():
    assert _msm(_points(24), [0] * 24, c=4) is None


def test_fused_msm_three_columns_and_several_blocks():
    """C = 3 columns over n = 256 points: two scan blocks of S = 128 per
    window, so the block offsets and the block-total prefix are used."""
    n = 256
    pts = _points(n)
    cols = [_scalars(n) for _ in range(3)]
    S = limbs.to_device(limbs.encode(FR, cols, mont=False), "cpu").movedim(1, 0)
    out = msm.msm_multi(curve.encode_points(pts, "cpu"), S, c=4, affine=True)
    assert curve.decode_points(out) == [hostcurve.g1_msm(pts, sc) for sc in cols]


def test_fold_all_and_reduce_pairwise_match_host():
    """`fold_all` over affine points whose count is no block multiple (so
    they are promoted and padded with identities) = the host sum."""
    pts = _points(200)
    x, y = (_enc(np.asarray([p[i] for p in pts], dtype=object)) for i in range(2))
    got = curve.decode_points(pcurve.fold_all((x, y), blk=128).map(lambda a: a[:, None]))[0]
    want = None
    for p in pts:
        want = hostcurve.g1_add(want, p)
    assert got == want


def test_scan_packed_treats_the_pad_pair_as_identity():
    """K4 reads the pair (0, 1) -- the affine image of `pad_msm_inputs`'
    identity lanes, on no curve y^2 = x^3 + 3 -- as the identity: at the
    first step, later, and for a whole lane; the prefixes equal the host's
    running sums of the other (sign-adjusted) points."""
    m, S = 3, 4
    pts = _points(m * S)
    for i in (0, 6, 8, 9, 10, 11):                     # (lane, step) (0,0), (1,2), lane 2
        pts[i] = None
    sn = RNG.integers(0, 2, size=(m, S))
    xs = np.asarray([0 if p is None else p[0] for p in pts], dtype=object).reshape(m, S)
    ys = np.asarray([1 if p is None else p[1] for p in pts], dtype=object).reshape(m, S)
    got = curve.decode_points(pcurve.prefix_scan_packed(
        _enc(xs), _enc(ys), torch.from_numpy(sn.astype(np.int32))))
    want = []
    for lane in range(m):
        acc = None
        for s in range(S):
            p = pts[lane * S + s]
            acc = hostcurve.g1_add(acc, hostcurve.g1_neg(p) if sn[lane, s] else p)
            want.append(acc)
    assert got == want


@pytest.mark.parametrize("lanes, team", [(1, 8), (26, 8), (104, 8), (111, 8), (832, 8),
                                         (1001, 8), (3328, 8), (4096, 8), (4097, 2),
                                         (6656, 2), (13312, 2), (26624, 2)])
def test_lane_team_sizes(lanes, team):
    """Threads per lane of K4, K5 and K6: 8 up to 4,096 lanes, 2 above, the
    limit each kernel's own H100 sweep put there. At k = 14 one column (3,328
    lanes of K4's and K5's scans, 26 groups of 128 of K6's fold) and K5's
    block-total prefix (26-832 lanes) take 8; two to eight columns
    (6,656-26,624 lanes) take 2."""
    assert pcurve.lane_team(lanes) == team
    assert team in pcurve.SCAN_TEAMS

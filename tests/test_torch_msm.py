"""The port's Pippenger MSM (`ezkl_tpu_torch.kernels.msm`, through the plain
versions of its kernels on the CPU) against the JAX package's host oracle
`ezkl_tpu.fieldmath.hostcurve.g1_msm`: the cases of `tests/test_msm.py` and
`tests/test_pallas_interpret.py:45-77`. `msm`/`msm_multi` are the fused
pipeline (K4-K8, `tests/test_torch_fused_msm.py` holds it bit-exact to the JAX
package); the blocked-scan cases drive the unfused one
(`msm_multi_unfused`, every group operation K3 or K9). Tolerance:
affine-equal results (projective MSM outputs are not unique)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ezkl_tpu.fieldmath import hostcurve as ref_host
from ezkl_tpu.fieldmath import limbs as ref_limbs
from ezkl_tpu.fieldmath.spec import bn254_fr as ref_fr
from ezkl_tpu.kernels import msm as ref_msm
from ezkl_tpu_torch import convert
from ezkl_tpu_torch.fieldmath import curve, limbs
from ezkl_tpu_torch.fieldmath.spec import bn254_fr
from ezkl_tpu_torch.kernels import msm

FR = bn254_fr()
RNG = np.random.default_rng(77)
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _points(n):
    return [ref_host.g1_mul(ref_host.G1, int(k)) for k in RNG.integers(1, 1 << 30, size=n)]


def _scalars(n):
    return [int.from_bytes(RNG.bytes(32), "little") % FR.modulus for _ in range(n)]


def _run(points, scalars, c=None, unfused=False):
    P = curve.encode_points(points, "cpu")
    S = limbs.to_device(limbs.encode(FR, scalars, mont=False), "cpu")
    P, S = msm.pad_msm_inputs(P, S)
    if unfused:
        out = msm.msm_multi_unfused(P, S[None], c=c).map(lambda a: a[..., 0])
    else:
        out = msm.msm(P, S, c=c)
    return curve.decode_points(out.map(lambda a: a[..., None]))[0]


def test_msm_matches_host_n32():
    pts, sc = _points(32), _scalars(32)
    assert _run(pts, sc) == ref_host.g1_msm(pts, sc)


@pytest.mark.parametrize("n, block", [(64, None), (256, 4)])
def test_msm_blocked_scan_matches_host(monkeypatch, n, block):
    """n > BLOCK: block-local prefixes plus block offsets, read at the bucket
    boundaries (the branch every k=14 commitment runs). With BLOCK = 4 at
    n = 256 the 64 block totals take the recursive prefix scan (two levels),
    as the 512 block totals of a 2^14-point MSM do at BLOCK = 32."""
    if block:
        monkeypatch.setattr(msm, "_BLOCK", block)
    pts, sc = _points(n), _scalars(n)
    assert _run(pts, sc, c=5, unfused=True) == ref_host.g1_msm(pts, sc)


def test_prefix_scan_points_recursive_matches_host():
    """`prefix_scan_points` over 2048 lanes (two recursion levels) against
    running sums of the host group law."""
    n = 2048
    pts = _points(n)
    got = curve.decode_points(msm.prefix_scan_points(curve.encode_points(pts, "cpu")))
    want, acc = [], None
    for pt in pts:
        acc = ref_host.g1_add(acc, pt)
        want.append(acc)
    assert got == want


def test_msm_non_power_of_two_with_identity_lanes():
    pts = _points(21) + [None, None, None]                      # n = 24 -> padded to 32
    sc = _scalars(20) + [0, 3, 5, FR.modulus - 1]
    assert _run(pts, sc, c=4) == ref_host.g1_msm(pts, sc)


def test_msm_all_zero_scalars_is_identity():
    assert _run(_points(8), [0] * 8, c=4) is None


def test_msm_multi_three_columns():
    n = 16
    pts = _points(n)
    cols = [_scalars(n) for _ in range(3)]
    S = limbs.to_device(limbs.encode(FR, cols, mont=False), "cpu").movedim(1, 0)  # (3, 8, n)
    out = msm.msm_multi(curve.encode_points(pts, "cpu"), S)
    assert curve.decode_points(out) == [ref_host.g1_msm(pts, sc) for sc in cols]


@pytest.mark.parametrize("c", [4, 13, 17])
def test_signed_digits_bit_exact_vs_reference(c):
    vals = [0, 1, FR.modulus - 1, (1 << 254) % FR.modulus] + _scalars(12)
    raw_ref = ref_limbs.encode(ref_fr(), vals, mont=False)
    mags, negs = msm.extract_digits_signed(convert.limbs_from_ref(raw_ref, "cpu"), c)
    rmags, rnegs = ref_msm.extract_digits_signed(jnp.asarray(raw_ref), c)
    np.testing.assert_array_equal(mags.numpy(), np.asarray(rmags))
    np.testing.assert_array_equal(negs.numpy(), np.asarray(rnegs))
    np.testing.assert_array_equal(
        msm.extract_digits(convert.limbs_from_ref(raw_ref, "cpu"), c).numpy(),
        np.asarray(ref_msm.extract_digits(jnp.asarray(raw_ref), c)))
    for k in (4, 10, 14, 17):
        assert msm.default_window_bits(1 << k) == ref_msm.default_window_bits(1 << k, True)


@pytest.mark.parametrize("form", ["lagrange", "coeff"])
def test_commit_lagrange_matches_host(form):
    """`kzg.commit_lagrange` (and `commit_coeff` on the coefficients) = MSM
    of the SRS points with the coefficients of the interpolated
    polynomial."""
    from ezkl_tpu.kernels import ntt as ref_ntt
    from ezkl_tpu_torch.plonk import kzg
    from ezkl_tpu_torch.plonk.srs import SRS
    n = 16
    pts, evals = _points(n), _scalars(n)
    srs = SRS(k=4, g1=curve.encode_points(pts, "cpu"), g2=None, s_g2=None)
    coeffs = ref_ntt.host_ntt(ref_fr(), evals, inverse=True)
    if form == "lagrange":
        got = kzg.commit_lagrange(srs, limbs.to_device(limbs.encode(FR, evals), "cpu"))
    else:
        got = kzg.commit_coeff(srs, limbs.to_device(limbs.encode(FR, coeffs), "cpu"))
    assert curve.decode_points(got.map(lambda a: a[..., None]))[0] == ref_host.g1_msm(pts, coeffs)

"""The port's G1 arithmetic (`ezkl_tpu_torch.fieldmath.curve`: K3 add and
K9 dbl through their plain versions on the CPU) against the JAX package's
`ezkl_tpu.fieldmath.curve` on the same projective inputs. Tolerance:
bit-exact projective coordinates; `scalar_mul` affine-equal to the host
oracle `hostcurve.g1_mul`."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ezkl_tpu.fieldmath import curve as ref_curve
from ezkl_tpu.fieldmath import hostcurve as ref_host
from ezkl_tpu.fieldmath import limbs as ref_limbs
from ezkl_tpu.fieldmath.spec import bn254_fq as ref_fq
from ezkl_tpu_torch import convert
from ezkl_tpu_torch.fieldmath import curve, limbs
from ezkl_tpu_torch.fieldmath.spec import bn254_fr

P = ref_host.P
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _projective(points, rng):
    """Host affine points (None = identity) -> reference PointP with a random
    Z per lane (X = xZ, Y = yZ), so the inputs are not affine."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
            continue
        z = int.from_bytes(rng.bytes(32), "little") % P or 1
        xs.append(pt[0] * z % P), ys.append(pt[1] * z % P), zs.append(z)
    fq = ref_fq()
    return ref_curve.PointP(*(jnp.asarray(ref_limbs.encode(fq, v)) for v in (xs, ys, zs)))


@pytest.fixture(scope="module")
def inputs():
    """p, q lanes: random multiples of G1, identity + P, P + P, P + (-P),
    identity + identity."""
    rng = np.random.default_rng(11)
    base = [ref_host.g1_mul(ref_host.G1, int(k)) for k in rng.integers(1, 1 << 60, size=5)]
    ps = base + [None, base[0], base[1], None]
    qs = base[::-1] + [base[2], base[0], ref_host.g1_neg(base[1]), None]
    return _projective(ps, rng), _projective(qs, rng), ps, qs


def _port(p):
    return convert.points_from_ref(p, "cpu")


def _same(port_pt, ref_pt):
    for a, b in zip(port_pt, ref_pt):
        np.testing.assert_array_equal(convert.limbs_to_ref(a), np.asarray(b))


def test_add_bit_exact_vs_reference(inputs):
    p, q, ps, qs = inputs
    out = curve.add(_port(p), _port(q))
    _same(out, ref_curve.add(p, q))
    assert curve.decode_points(out) == [ref_host.g1_add(a, b) for a, b in zip(ps, qs)]


def test_dbl_bit_exact_vs_reference(inputs):
    p, _, ps, _ = inputs
    out = curve.dbl(_port(p))
    _same(out, ref_curve.dbl(p))
    assert curve.decode_points(out) == [ref_host.g1_add(a, a) for a in ps]


def test_scalar_mul_affine_equal_to_host():
    fr = bn254_fr()
    rng = np.random.default_rng(5)
    ks = [0, 1, fr.modulus - 1] + [int.from_bytes(rng.bytes(32), "little") % fr.modulus
                                    for _ in range(3)]
    bits = curve.scalars_to_bits(limbs.to_device(limbs.encode(fr, ks, mont=False), "cpu"))
    out = curve.scalar_mul(curve.generator((len(ks),), "cpu"), bits)
    assert curve.decode_points(out) == [ref_host.g1_mul(ref_host.G1, k) for k in ks]


def test_encode_decode_and_neg():
    pts = [ref_host.g1_mul(ref_host.G1, k) for k in (3, 5)] + [None]
    enc = curve.encode_points(pts, "cpu")
    assert curve.decode_points(enc) == pts
    assert curve.decode_points(curve.neg(enc)) == [ref_host.g1_neg(pt) for pt in pts]
    ident = curve.identity((2,), "cpu")
    assert bool(curve.is_identity(ident).all())


_REF_ADD = None


@pytest.fixture(scope="module")
def base_points():
    rng = np.random.default_rng(23)
    return [ref_host.g1_mul(ref_host.G1, int(k)) for k in rng.integers(1, 1 << 60, size=7)]


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("w", [1, 2, 128])
def test_reduce_pairwise_word_equal_vs_reference(monkeypatch, base_points, w, groups):
    """K3's tree form (`pcurve.reduce_pairwise`, here its plain version, the
    loop of `point_add_plain`) against the JAX package's
    `ezkl_tpu.kernels.pcurve.reduce_pairwise` on (8, groups, w) partials
    with identity lanes (a whole group of them when there are three).
    That function adds through the TPU kernel `_add_call`, which needs a
    TPU; as the JAX package's non-TPU paths do, its adds run in this test through
    `ezkl_tpu.fieldmath.curve.add`, the same RCB15 schedule in XLA, whose
    words the TPU kernel matches -- one compiled add for every case, each
    level's (groups, lanes) zero-padded to (3, 64) (an add is lane by lane;
    the padding lanes are dropped). Tolerance: equal projective words."""
    import jax
    from ezkl_tpu.kernels import pcurve as ref_pcurve
    from ezkl_tpu_torch.kernels import pcurve
    global _REF_ADD
    if _REF_ADD is None:
        _REF_ADD = jax.jit(ref_curve.add)

    def padded_add(p, q):
        g, half = p.x.shape[1:]
        pad = lambda t: jnp.pad(t, [(0, 0), (0, 3 - g), (0, 64 - half)])  # noqa: E731
        out = _REF_ADD(ref_curve.PointP(*map(pad, p)), ref_curve.PointP(*map(pad, q)))
        return ref_curve.PointP(*(c[:, :g, :half] for c in out))

    monkeypatch.setattr(ref_pcurve, "add", padded_add)
    rng = np.random.default_rng(w + groups)
    pts = [None if rng.random() < 0.1 else base_points[int(rng.integers(0, 7))]
           for _ in range(groups * w)]
    pts[0] = None
    if groups == 3:
        pts[w:2 * w] = [None] * w
    ref = _projective(pts, rng)
    ref = ref_curve.PointP(*(c.reshape((16, groups, w)) for c in ref))
    got = pcurve.reduce_pairwise(_port(ref))
    want = ref_pcurve.reduce_pairwise(ref)
    _same(got, want)
    sums = [None] * groups
    for g in range(groups):
        for pt in pts[g * w:(g + 1) * w]:
            sums[g] = ref_host.g1_add(sums[g], pt)
    assert curve.decode_points(got) == sums

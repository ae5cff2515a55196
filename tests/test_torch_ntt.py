"""The port's NTT (`ezkl_tpu_torch.kernels.ntt`; every stage is K2 `bfly`,
here through its plain version) against the JAX package's
`ezkl_tpu.kernels.ntt`: its O(n^2) bigint oracle `host_ntt` at n = 16 and
64, and its compiled `ntt_jit` at n = 16. Tolerance: bit-exact (canonical
Montgomery limbs, so equal integers are equal arrays)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ezkl_tpu.fieldmath import limbs as ref_limbs
from ezkl_tpu.fieldmath.spec import bn254_fr as ref_fr
from ezkl_tpu.kernels import ntt as ref_ntt
from ezkl_tpu_torch import convert
from ezkl_tpu_torch.fieldmath import limbs
from ezkl_tpu_torch.fieldmath.spec import bn254_fr
from ezkl_tpu_torch.kernels import ntt, pntt

FR = bn254_fr()
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core
P = FR.modulus


def _values(n, seed):
    rng = np.random.default_rng(seed)
    return [0, 1, P - 1] + [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n - 3)]


def _coset(vals, inverse=False):
    g = FR.generator if not inverse else pow(FR.generator, -1, P)
    return [v * pow(g, j, P) % P for j, v in enumerate(vals)]


ORACLES = {
    "ntt": (ntt.ntt, lambda v: ref_ntt.host_ntt(ref_fr(), v)),
    "intt": (ntt.intt, lambda v: ref_ntt.host_ntt(ref_fr(), v, inverse=True)),
    "coset_ntt": (ntt.coset_ntt, lambda v: ref_ntt.host_ntt(ref_fr(), _coset(v))),
    "coset_intt": (ntt.coset_intt,
                   lambda v: _coset(ref_ntt.host_ntt(ref_fr(), v, inverse=True), inverse=True)),
}


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("which", sorted(ORACLES))
def test_transform_matches_host_oracle(which, n):
    vals = _values(n, seed=n)
    fn, oracle = ORACLES[which]
    got = fn(FR, limbs.to_device(limbs.encode(FR, vals), "cpu"))
    assert [int(v) for v in limbs.decode(FR, got)] == oracle(vals)


def test_ntt_bit_exact_vs_reference_jit():
    """Batched (8, L, n) input against the reference's compiled transform."""
    vals = [_values(16, seed=s) for s in (1, 2)]
    x_ref = ref_limbs.encode(ref_fr(), vals)                    # (16, 2, 16)
    got = ntt.ntt(FR, convert.limbs_from_ref(x_ref, "cpu"))
    want = ref_ntt.ntt_jit(ref_fr(), jnp.asarray(x_ref))
    np.testing.assert_array_equal(convert.limbs_to_ref(got), np.asarray(want))


def test_round_trips_and_stage_layout():
    x = limbs.to_device(limbs.encode(FR, _values(64, seed=9)), "cpu")
    assert ntt.intt(FR, ntt.ntt(FR, x)).equal(x)
    assert ntt.coset_intt(FR, ntt.coset_ntt(FR, x)).equal(x)
    # one stage: blocks of 2*half, (a + b w, a - b w) with w[j] per block position
    w = limbs.to_device(limbs.encode(FR, [3, 5]), "cpu")
    out = limbs.decode(FR, pntt.bfly(FR, x[:, :8], w))
    xs = limbs.decode(FR, x[:, :8])
    want = []
    for blk in (0, 4):
        a, b = xs[blk:blk + 2], xs[blk + 2:blk + 4]
        t = [b[j] * (3, 5)[j] % P for j in range(2)]
        want += [(a[j] + t[j]) % P for j in range(2)] + [(a[j] - t[j]) % P for j in range(2)]
    assert [int(v) for v in out] == want


@pytest.mark.parametrize("inverse", [False, True])
def test_vanishing_on_extended_bit_exact_vs_reference(inverse):
    """Z_H (or 1/Z_H) over the extended coset, k = 4, degree-5 gates."""
    from ezkl_tpu.plonk.domain import domain as ref_domain
    from ezkl_tpu_torch.plonk.domain import domain
    ref, own = ref_domain(4, gate_degree=5), domain(4, gate_degree=5)
    assert (own.k, own.extended_k) == (ref.k, ref.extended_k)
    if inverse:
        got, want = own.vanishing_inv_on_extended("cpu"), ref.vanishing_inv_on_extended()
    else:
        got, want = own.vanishing_on_extended("cpu"), ref.vanishing_on_extended()
    np.testing.assert_array_equal(convert.limbs_to_ref(got), np.asarray(want))


def test_kzg_evaluations_match_host():
    """Barycentric `eval_at`, coefficient `eval_coeff_at` and the opening
    witness `open_witness_evals` of `plonk.kzg` against host bigints."""
    from ezkl_tpu_torch.plonk import kzg
    k, z = 4, 0xC0FFEE
    n = 1 << k
    vals = _values(n, seed=3)
    evals = limbs.to_device(limbs.encode(FR, vals), "cpu")
    coeffs = ref_ntt.host_ntt(ref_fr(), vals, inverse=True)
    pz = sum(c * pow(z, j, P) for j, c in enumerate(coeffs)) % P
    dec = lambda t: int(limbs.decode(FR, t[:, None])[0])    # noqa: E731
    assert dec(kzg.eval_at(evals, z, k)) == pz
    assert dec(kzg.eval_coeff_at(ntt.intt(FR, evals), z, k)) == pz
    w = ntt.root_of_unity(FR, k)
    wit = kzg.open_witness_evals(evals, limbs.const(FR, pz, device="cpu"), z, k)
    want = [(v - pz) * pow(pow(w, i, P) - z, -1, P) % P for i, v in enumerate(vals)]
    assert [int(v) for v in limbs.decode(FR, wit)] == want


# --- K2's passes: several stages per launch -------------------------------

@pytest.mark.parametrize("k", range(1, 22))
def test_pass_split_covers_every_stage_once(k):
    """`pntt.pass_split(k)`: contiguous passes over stages 1 .. k, each of
    at most 10 stages, ceil(k / 10) of them, lengths within one."""
    split = pntt.pass_split(k)
    assert [s0 for s0, _ in split] == [sum(r for _, r in split[:i]) for i in range(len(split))]
    assert sum(r for _, r in split) == k
    assert len(split) == -(-k // 10)
    rs = [r for _, r in split]
    assert max(rs) <= pntt.MAX_STAGES and max(rs) - min(rs) <= 1


@pytest.mark.parametrize("cols", [1, 3, 16])
def test_groups_per_block_within_the_kernels_limits(cols):
    """Every pass's choice fits `ez_ntt_stages`: a tile of <= 1024 elements,
    no more groups than one stride run (2^s0) past the first pass, and whole
    blocks over the groups."""
    for k in range(1, 22):
        for s0, r in pntt.pass_split(k) + [(s0, 1) for s0 in range(k)]:
            log_gb = pntt.groups_per_block(cols, k, s0, r)
            assert 0 <= log_gb <= pntt.max_log_groups(k, s0, r)
            gb = 1 << log_gb
            assert gb << r <= pntt.TILE
            assert s0 == 0 or gb <= 1 << s0
            assert (cols << (k - r)) % gb == 0


@pytest.mark.parametrize("k, s0, r", [(1, 0, 1), (4, 0, 4), (6, 2, 3), (11, 6, 5), (12, 0, 6),
                                      (12, 6, 6), (12, 2, 10)])
def test_stages_plain_is_r_single_stages(k, s0, r):
    """`stages_plain(k, s0, r)` equals r one-stage `bfly_plain` calls, stage
    s with the table w_{2^s}^j = master[j * 2^(k-s)] cut from the master
    table as the JAX package cuts it (`ezkl_tpu/kernels/ntt.py:188-197`)."""
    n = 1 << k
    rng = np.random.default_rng(100 + k)
    x = limbs.to_device(limbs.encode(FR, [int(v) for v in rng.integers(0, 1 << 62, size=2 * n)]),
                        "cpu").reshape(8, 2, n)
    for inverse in (False, True):
        master = ntt.twiddles(FR, k, inverse, "cpu")
        want = x
        for s in range(s0 + 1, s0 + r + 1):
            want = pntt.bfly_plain(FR, want, master[:, :: n // (1 << s)].contiguous())
        assert pntt.stages_plain(FR, x, master, k, s0, r).equal(want)


def _host_transform(cols, which):
    """`ntt`, `intt` or `coset_ntt` of host int columns by the radix-2 DIT
    on Python ints, with the JAX package's roots of unity and coset
    generator: the reference oracle where its O(n^2) `host_ntt` and its
    compiled `ntt_jit` (20-35 s to compile per shape at k = 11, 12 on an
    8-core x86 CPU) are too slow."""
    fr = ref_fr()
    out = []
    for vals in cols:
        n = len(vals)
        k = n.bit_length() - 1
        inverse = which == "intt"
        if which == "coset_ntt":
            vals = _coset(vals)
        x = [vals[int(j)] for j in ntt._bitrev_perm(k)] if k else list(vals)
        w = ref_ntt.root_of_unity(fr, k, inverse) if k else 1
        for s in range(1, k + 1):
            m = 1 << s
            wm = pow(w, n // m, P)
            for blk in range(0, n, m):
                t = 1
                for j in range(m // 2):
                    a, b = x[blk + j], x[blk + j + m // 2] * t % P
                    x[blk + j], x[blk + j + m // 2] = (a + b) % P, (a - b) % P
                    t = t * wm % P
        if inverse:
            ninv = pow(n, -1, P)
            x = [v * ninv % P for v in x]
        out.append(x)
    return out


TRANSFORMS = {"ntt": ntt.ntt, "intt": ntt.intt, "coset_ntt": ntt.coset_ntt}


@pytest.mark.parametrize("batch", [(), (2, 3)], ids=["single", "batch2x3"])
@pytest.mark.parametrize("k", [1, 5, 11, 12])
@pytest.mark.parametrize("which", sorted(TRANSFORMS))
def test_transform_through_the_pass_split_bit_exact(which, k, batch):
    """`ntt`, `intt` and `coset_ntt` run their stages in `pass_split(k)`
    passes (k = 11: 6 + 5, k = 12: 6 + 6) on either device; here the plain
    passes, bit-exact against the reference: its compiled `ntt_jit`,
    `intt_jit` and `coset_ntt_jit` at k = 1, its `ntt_jit` at k = 5 over the
    batch, and everywhere the radix-2 host oracle above."""
    n = 1 << k
    rng = np.random.default_rng(7 * k + len(batch))
    vals = rng.integers(0, 1 << 62, size=batch + (n,)).astype(object)
    edge = [0, 1, P - 1][:vals.size]
    vals.reshape(-1)[:len(edge)] = edge
    x_ref = ref_limbs.encode(ref_fr(), vals.reshape(-1).tolist()).reshape((16,) + batch + (n,))
    got = TRANSFORMS[which](FR, convert.limbs_from_ref(x_ref, "cpu"))
    cols = vals.reshape(-1, n).tolist()
    host = np.array(_host_transform(cols, which), dtype=object).reshape(batch + (n,))
    dec = np.array([int(v) for v in limbs.decode(FR, got.reshape(8, -1))],
                   dtype=object).reshape(batch + (n,))
    assert (dec == host).all()
    if k == 1 or (k == 5 and batch and which == "ntt"):
        jit = {"ntt": ref_ntt.ntt_jit, "intt": ref_ntt.intt_jit,
               "coset_ntt": ref_ntt.coset_ntt_jit}[which]
        want = jit(ref_fr(), jnp.asarray(x_ref))
        np.testing.assert_array_equal(convert.limbs_to_ref(got), np.asarray(want))


def test_domain_transforms_and_horner_equal_the_reference():
    """`Domain.lagrange_to_coeff`, `coeff_to_lagrange` and `eval_coeff_at`
    of the port against the JAX package's `Domain` at k = 3 (its transforms
    compiled once each) on seeded values: the same words and the same
    integer."""
    from ezkl_tpu.plonk import domain as ref_domain
    from ezkl_tpu_torch.plonk import domain

    vals = _values(8, 23)
    ref_d, d = ref_domain.domain(3), domain.domain(3)
    a_ref = jnp.asarray(ref_limbs.encode(ref_fr(), vals))
    a = limbs.to_device(limbs.encode(FR, vals), "cpu")
    coeff_ref = ref_d.lagrange_to_coeff(a_ref)
    coeff = d.lagrange_to_coeff(a)
    np.testing.assert_array_equal(limbs.host_words(coeff), convert.words_from_ref(coeff_ref))
    np.testing.assert_array_equal(limbs.host_words(d.coeff_to_lagrange(coeff)),
                                  convert.words_from_ref(ref_d.coeff_to_lagrange(coeff_ref)))
    np.testing.assert_array_equal(limbs.host_words(d.coeff_to_lagrange(coeff)),
                                  limbs.host_words(a))
    for x in (0, 1, 12345, P - 1):
        assert d.eval_coeff_at(coeff, x) == ref_d.eval_coeff_at(coeff_ref, x)
    assert d.eval_coeff_at(coeff, 7) == sum(v * pow(7, j, P) for j, v in enumerate(
        limbs.decode(FR, coeff))) % P

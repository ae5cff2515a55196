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

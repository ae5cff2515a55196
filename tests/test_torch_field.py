"""The port's field arithmetic (`ezkl_tpu_torch.fieldmath.limbs`, on the CPU
through the plain versions) against the JAX package's
(`ezkl_tpu.fieldmath.limbs`) on the same inputs. Tolerance: bit-exact (the
port's (8, n) words converted to the reference's (16, n) limbs are equal
array for array)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ezkl_tpu.fieldmath import limbs as ref
from ezkl_tpu.fieldmath import spec as ref_spec
from ezkl_tpu_torch import convert
from ezkl_tpu_torch.fieldmath import limbs
from ezkl_tpu_torch.fieldmath.spec import bn254_fq, bn254_fr

N = 12
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core
SPECS = {"fr": (bn254_fr(), ref_spec.bn254_fr()), "fq": (bn254_fq(), ref_spec.bn254_fq())}


def _values(p, seed):
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(N - 3)]
    return [0, 1, p - 1] + rand          # the cases of tests/test_field.py + random


def _pair(field, seed):
    """The same Montgomery inputs for both packages: (ref arrays, port tensors)."""
    spec, rspec = SPECS[field]
    a_ref = ref.encode(rspec, _values(spec.modulus, seed))
    b_ref = ref.encode(rspec, _values(spec.modulus, seed + 1)[::-1])
    return (a_ref, b_ref), (convert.limbs_from_ref(a_ref, "cpu"), convert.limbs_from_ref(b_ref, "cpu"))


def _same(port, ref_out):
    np.testing.assert_array_equal(convert.limbs_to_ref(port), np.asarray(ref_out))


OPS = {
    "mont_mul": (lambda s, a, b: limbs.mont_mul(s, a, b), lambda s, a, b: ref.mont_mul(s, a, b)),
    "add": (lambda s, a, b: limbs.add(s, a, b), lambda s, a, b: ref.add(s, a, b)),
    "sub": (lambda s, a, b: limbs.sub(s, a, b), lambda s, a, b: ref.sub(s, a, b)),
    "batch_inv": (lambda s, a, b: limbs.batch_inv(s, a), lambda s, a, b: ref.batch_inv(s, a)),
    "prefix_scan_mul": (lambda s, a, b: limbs.prefix_scan_mul(s, a),
                        lambda s, a, b: ref.prefix_scan_mul(s, a)),
}


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("op", sorted(OPS))
def test_field_op_bit_exact_vs_reference(field, op):
    spec, rspec = SPECS[field]
    (a_ref, b_ref), (a, b) = _pair(field, seed=7)
    port_fn, ref_fn = OPS[op]
    _same(port_fn(spec, a, b), ref_fn(rspec, jnp.asarray(a_ref), jnp.asarray(b_ref)))


@pytest.mark.parametrize("field", sorted(SPECS))
def test_powers_bit_exact_vs_reference(field):
    spec, rspec = SPECS[field]
    base = 0x1234567890ABCDEF1234567890ABCDEF % spec.modulus
    _same(limbs.powers(spec, base, N, "cpu"), ref.powers(rspec, base, N))
    # powers_dynamic (device base) agrees with the host table
    dyn = limbs.powers_dynamic(spec, limbs.const(spec, base, device="cpu"), N)
    _same(dyn, ref.powers(rspec, base, N))


@pytest.mark.parametrize("field", sorted(SPECS))
def test_against_host_bigints(field):
    """Plain versions vs Python ints, incl. conversions in and out of
    Montgomery form, neg, inv and the suffix scan."""
    spec, _ = SPECS[field]
    p = spec.modulus
    xs, ys = _values(p, 3), _values(p, 4)
    a = limbs.to_device(limbs.encode(spec, xs), "cpu")
    b = limbs.to_device(limbs.encode(spec, ys), "cpu")
    dec = lambda t: [int(v) for v in limbs.decode(spec, t)]   # noqa: E731
    assert dec(limbs.mont_mul(spec, a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert dec(limbs.neg(spec, a)) == [(-x) % p for x in xs]
    assert dec(limbs.inv(spec, a)) == [pow(x, -1, p) if x else 0 for x in xs]
    raw = limbs.from_mont(spec, a)
    assert [int(v) for v in limbs.decode(spec, raw, mont=False)] == xs
    assert dec(limbs.to_mont(spec, raw)) == xs
    suffix = dec(limbs.prefix_scan_mul(spec, a, reverse=True))
    want, acc = [], 1
    for x in reversed(xs):
        acc = acc * x % p
        want.append(acc)
    assert suffix == want[::-1]
    assert dec(limbs.prefix_scan_add(spec, a))[-1] == sum(xs) % p


def test_layout_round_trip_and_i64_encoding():
    """convert's word packing is `msm._pack2` of the reference layout, and
    encode_i64 maps negatives to p - |x| as the reference does."""
    spec, rspec = SPECS["fr"]
    vals = np.array([0, 1, -1, 2**40, -(2**62), 12345], dtype=np.int64)
    ref_raw = ref.encode_i64(rspec, vals)
    np.testing.assert_array_equal(convert.words_from_ref(ref_raw), limbs.encode_i64(spec, vals))
    np.testing.assert_array_equal(convert.limbs_to_ref(limbs.encode_i64(spec, vals)), ref_raw)
    rows = limbs.pack_rows(limbs.encode_i64(spec, vals))
    assert len(set(rows.tolist())) == len(vals)


@pytest.mark.parametrize("a_shape, b_shape, representable", [
    ((8, 3, 16), (8, 1, 1), True),           # a constant
    ((8, 3, 16), (8, 1, 16), True),          # one row over a batch (coset powers)
    ((8, 3, 16), (8, 3, 1), True),           # one value per row (batch_inv's total_inv)
    ((8, 2, 3, 4), (8, 1, 3, 1), True),      # a run of middle dims
    ((8, 3, 16), (8, 3, 16), True),          # no broadcast
    ((8, 2, 3, 4), (8, 2, 1, 4), False),     # not one run: K1 gets a copy
])
def test_k1_broadcast_operand_index(a_shape, b_shape, representable):
    """The index map of K1's broadcast operand: element j of the output reads
    b[(j // repeat) % period] (`bcast_form`, mirrored by `ez_mont_mul`);
    an expanded (stride-0) operand is read at its unexpanded size."""
    import torch
    shape = torch.broadcast_shapes(a_shape, b_shape)
    b = torch.arange(int(np.prod(b_shape)), dtype=torch.int32).reshape(b_shape)
    form = limbs.bcast_form(b_shape, shape)
    assert (form is not None) == representable
    if form is not None:
        period, rep = form
        j = torch.arange(int(np.prod(shape[1:])))
        want = b.expand(shape).reshape(8, -1)
        assert torch.equal(b.reshape(8, period)[:, (j // rep) % period], want)
        assert limbs._unexpand(b.expand(shape)).shape == b_shape


# A host program over `csrc/bcast.cuh`, the broadcast operand map of K1's
# `ez_mont_mul`, built with `tools/cuda_emu` in place of CUDA. Reads lines
# "d <divisor> <count> <x>..." (prints the divisor's m and s, then x / d by
# `div_by` for each x) and "m <n> <period> <rep>" (prints the form the entry
# picks, then the element of b that each output j < n reads).
_BCAST_HOST = r"""
#include "cuda_runtime.h"
#include "bcast.cuh"
#include <cstdio>
using namespace bcast;
template <int F>
void map(long long n, const Divisor& p, const Divisor& r) {
  for (long long j = 0; j < n; ++j) printf(" %u", b_index<F>((uint32_t)j, p, r));
}
int main() {
  char op[2];
  while (scanf("%1s", op) == 1) {
    if (op[0] == 'd') {
      long long d, k, x;
      if (scanf("%lld %lld", &d, &k) != 2) return 1;
      const Divisor v = divisor((uint32_t)d);
      printf("%u %d", v.m, v.s);
      for (long long i = 0; i < k && scanf("%lld", &x) == 1; ++i)
        printf(" %u", div_by((uint32_t)x, v));
    } else {
      long long n, period, rep;
      if (scanf("%lld %lld %lld", &n, &period, &rep) != 3) return 1;
      const Form f = form_of(n, period, rep);
      const Divisor p = divisor((uint32_t)period), r = divisor((uint32_t)rep);
      printf("%d", (int)f);
      if (f == kDense) map<kDense>(n, p, r);
      else if (f == kConst) map<kConst>(n, p, r);
      else if (f == kRow) map<kRow>(n, p, r);
      else map<kGeneral>(n, p, r);
    }
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def bcast_host(tmp_path_factory):
    """Runs `_BCAST_HOST` on lines of input; returns its lines of ints."""
    import pathlib
    import shutil
    import subprocess
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/bcast.cuh")
    root = pathlib.Path(__file__).resolve().parent.parent
    d = tmp_path_factory.mktemp("bcast")
    (d / "host.cpp").write_text(_BCAST_HOST)
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", f"-I{root / 'tools' / 'cuda_emu'}",
                    f"-I{root / 'ezkl_tpu_torch' / 'csrc'}", "-o", str(d / "host"),
                    str(d / "host.cpp")], check=True)

    def run(lines):
        out = subprocess.run([str(d / "host")], input="\n".join(lines) + "\n",
                             capture_output=True, text=True, check=True).stdout
        return [[int(v) for v in line.split()] for line in out.splitlines()]
    return run


@pytest.mark.parametrize("d", [2, 3, 5, 6, 7, 16, 20, 48, 641, 16384, 16385, 3 * 2 ** 20,
                               (1 << 30) + 1, (1 << 31) - 1])
def test_divisor_magic_divides_every_31_bit_index(bcast_host, d):
    """`bcast::divisor`, the magic by which `ez_mont_mul`'s entry lets its
    kernel divide by b's period and repeat: a 32-bit m, and
    umulhi(x, m) >> s == x // d over edges and random x < 2^31."""
    rng = np.random.default_rng(d)
    xs = [0, 1, d - 1, d, d + 1, 2 * d - 1, (1 << 31) - 1, (1 << 31) - 2,
          ((1 << 31) - 1) // d * d, ((1 << 31) - 1) // d * d - 1] + \
        [int(x) for x in rng.integers(0, 1 << 31, size=2000)]
    xs = [x for x in xs if x < 1 << 31]
    (m, s, *q), = bcast_host([f"d {d} {len(xs)} " + " ".join(map(str, xs))])
    assert 0 < m < 1 << 32 and s >= 0
    assert q == [x // d for x in xs]


@pytest.mark.parametrize("a_shape, b_shape", [
    ((8, 3, 16), (8, 1, 1)),
    ((8, 3, 16), (8, 1, 16)),
    ((8, 3, 16), (8, 3, 1)),
    ((8, 2, 3, 4), (8, 1, 3, 1)),
    ((8, 3, 16), (8, 3, 16)),
    ((8, 5, 6), (8, 1, 6)),          # widths that are no multiple of 4
    ((8, 5, 6), (8, 5, 1)),
    ((8, 7, 3, 5), (8, 1, 3, 1)),
    ((8, 9, 7), (8, 9, 1)),
    ((8, 7, 9, 11), (8, 1, 9, 1)),
    ((8, 16, 8192), (8, 1, 8192)),   # the prove's 2^17: a row over a batch
    ((8, 16, 8192), (8, 16, 1)),     # and one value per row
])
def test_k1_magic_index_is_the_broadcast_map(bcast_host, a_shape, b_shape):
    """The element `ez_mont_mul` reads for output j, in the form its entry
    picks (`bcast.cuh`) -- dense (period = n): j; constant (period = 1): 0;
    row (rep = 1): j - (j / period) * period; general: q = j / rep,
    q - (q / period) * period, each division by the entry's magic -- equals
    (j // rep) % period, the map of `bcast_form`, at every j."""
    shape = torch.broadcast_shapes(a_shape, b_shape)
    period, rep = limbs.bcast_form(b_shape, shape)
    n = int(np.prod(shape[1:]))
    (form, *jb), = bcast_host([f"m {n} {period} {rep}"])
    assert form == (0 if period == n else 1 if period == 1 else 2 if rep == 1 else 3)
    j = np.arange(n, dtype=np.int64)
    np.testing.assert_array_equal(np.asarray(jb, np.int64), (j // rep) % period)


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("e", ["0", "1", "2", "p-2"])
def test_pow_static_plain_bit_exact_vs_reference(field, e):
    """K1's `mont_pow` form as its plain version runs it, zeros in the batch."""
    spec, rspec = SPECS[field]
    exp = spec.modulus - 2 if e == "p-2" else int(e)
    (a_ref, _), (a, _) = _pair(field, seed=11)          # element 0 is zero
    _same(limbs.pow_static_plain(spec, a, exp), ref.pow_static(rspec, jnp.asarray(a_ref), exp))
    _same(limbs.pow_static(spec, a, exp), ref.pow_static(rspec, jnp.asarray(a_ref), exp))


@pytest.mark.parametrize("field", sorted(SPECS))
def test_pow_schedule_rebuilds_the_exponent(field):
    """`ez_mont_pow`'s sliding-window schedule: the windows, shifted in,
    give back the exponent; at most 64 windows and 8 table entries."""
    spec, _ = SPECS[field]
    rng = np.random.default_rng(5)
    exps = [1, 2, 3, 16, 17, 0x10001, spec.modulus - 2, (1 << 255) + 1, (1 << 256) - 1,
            int("10" * 128, 2), int("1000" * 64, 2)] + [
        int.from_bytes(rng.bytes(32), "little") | 1 for _ in range(20)]
    for e in exps:
        first, windows, trailing, products = limbs.pow_schedule(e)
        v = 2 * first + 1
        for sq, dig in windows:
            assert 0 <= dig < 8 and sq >= 1
            v = (v << sq) + 2 * dig + 1
        assert v << trailing == e
        assert len(windows) <= 64
        assert products == 8 + sum(sq for sq, _ in windows) + len(windows) + trailing
    assert limbs.pow_schedule(spec.modulus - 2)[3] < spec.modulus.bit_length() + 64


@pytest.mark.parametrize("steps", [1, 31, 32, 33, 1025])
def test_prefix_scan_mul_over_rows_bit_exact_vs_reference(steps):
    """`prefix_scan_mul` (its blocks through `seq_scan_mul_plain` on the CPU)
    over three rows, at block-edge lengths and two levels of recursion (Fr;
    the Fq scan is in `test_field_op_bit_exact_vs_reference`)."""
    spec, rspec = SPECS["fr"]
    rng = np.random.default_rng(steps)
    vals = [[int.from_bytes(rng.bytes(32), "little") % spec.modulus for _ in range(steps)]
            for _ in range(3)]
    v_ref = ref.encode(rspec, vals)
    v = convert.limbs_from_ref(v_ref, "cpu")
    _same(limbs.prefix_scan_mul(spec, v), ref.prefix_scan_mul(rspec, jnp.asarray(v_ref)))
    if steps <= 33:
        _same(limbs.seq_scan_mul_plain(spec, v), ref.prefix_scan_mul(rspec, jnp.asarray(v_ref)))

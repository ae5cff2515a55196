"""Work counts of an ideal prover, from a circuit's shapes."""

import pytest

from benchmark import work

CONV_K20 = {"k": 20, "extended_k": 23, "num_fixed": 31, "num_advice": 8, "num_instance": 1,
            "lookups": [[1, 1]] * 5, "shuffles": [], "perm_columns": 10,
            "gate_products": 60, "gates": 15, "rotations": [0, 1], "queries": 40}


def test_window_minimises_the_products():
    for n in (1 << 10, 1 << 13, 1 << 20):
        c = work.window_bits(n)
        best = work.msm_products(n)
        assert all(work._msm(n, other) >= best for other in range(1, 25))
        assert 2 <= c <= 20
    assert work.window_bits(1 << 20) in (15, 16)


def test_msm_products_by_hand():
    # n = 2^20, c = 16: 16 windows; 16 * 2^20 mixed adds, 16 * 2 * (2^16 - 1)
    # full adds, 15 * (16 doublings + 1 add)
    n, c = 1 << 20, 16
    want = (16 * n * work.MIXED_ADD + 16 * 2 * ((1 << c) - 1) * work.FULL_ADD
            + 15 * (c * work.DOUBLE + work.FULL_ADD))
    assert work._msm(n, c) == want
    assert work.msm_products(n) <= want


def test_transform_counts_and_bounds():
    assert work.ntt_products(3) == 12
    # a 2^23 transform is bound by its products, not its bytes
    assert work.seconds_of(work.ntt_products(23)) > 64 * (1 << 23) / work.HBM_BYTES_PER_S
    assert work.ntt_seconds(23) == pytest.approx(
        (1 << 22) * 23 * work.IMAD_PER_PRODUCT / work.IMAD_PER_S)
    # advice 8 + instance 1 + m and phi of 5 lookups + 2 perm chunks, and the
    # random polynomial and the quotient
    assert work.transforms(CONV_K20) == [(20, 22), (23, 22)]


def test_commitments_of_the_conv_circuit():
    # advice 8, m + phi 10, perm chunks 2, random 1, h pieces 8, openings at
    # x, wx and the closing row (two chunks link there): 32
    assert work.commitments(CONV_K20) == 32
    assert work.opening_points(CONV_K20) == {0, 1, ("last",)}


def test_prove_products_hold_their_parts():
    total = work.prove_products(CONV_K20)
    msm = work.commitments(CONV_K20) * work.msm_products(1 << 20)
    assert total > msm
    # the prediction's order: some 10^10 products, a fraction of a second
    assert 5e9 < total < 5e10
    assert 0.1 < work.seconds_of(total) < 2.0


def test_share():
    assert work.share(1.0, 4.0) == 25.0
    assert work.share(1.0, 0.0) is None

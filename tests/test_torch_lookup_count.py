"""Phase 3's lookup multiplicities counted with tensor operations
(`prover.lookup_multiplicities`), held on the CPU against the host count the
prover ran before (`_host_m` below: structured-row sort, search and
bincount in numpy): the same m on every row, the same error for an input
missing from the table, and `prover.LOOKUP_ROWS` filled by a proof."""

import zlib

import numpy as np
import pytest
import torch

from ezkl_tpu_torch.fieldmath import limbs
from ezkl_tpu_torch.fieldmath.spec import bn254_fr, NWORDS
from ezkl_tpu_torch.plonk import cs, keygen, prover, srs as srsmod, verifier
from ezkl_tpu_torch.plonk.assign import Assignment

import torch_port_circuits as circuits

FR = bn254_fr()
N, A = 256, 230
TOP = 0x30000000          # word 7 below this keeps a value below the modulus
torch.set_num_threads(1)  # small tensors; pytest-xdist runs one worker per core


def _host_m(name, t, fs, a, n):
    """The numpy count: lowest-indexed table row [:a] of each input row's
    value, by stable argsort of the packed table and searchsorted."""
    t_pack = limbs.pack_rows(limbs.from_mont(FR, t))[:a]
    order = np.argsort(t_pack, kind="stable")
    t_sorted = t_pack[order]
    f_all = np.concatenate([limbs.pack_rows(limbs.from_mont(FR, f))[:a] for f in fs])
    pos = np.searchsorted(t_sorted, f_all)
    pos_c = np.minimum(pos, t_sorted.size - 1)
    ok = t_sorted[pos_c] == f_all
    if not ok.all():
        raise ValueError(f"lookup '{name}': {int((~ok).sum())} input values not in table")
    run_start = np.r_[True, t_sorted[1:] != t_sorted[:-1]]
    run_first = np.maximum.accumulate(np.where(run_start, np.arange(t_sorted.size), 0))
    return np.bincount(order[run_first[pos_c]], minlength=n).astype(np.int64)


def _pool(rng, count, vary=None):
    """(8, count) distinct raw field elements: every word random, or, for
    vary = j, one random value with only key j's words (2j, 2j + 1) varied;
    high bits set so that some keys read negative."""
    words = rng.integers(0, 1 << 32, size=(NWORDS, count), dtype=np.uint64)
    if vary is not None:
        fixed = np.ones(NWORDS, bool)
        fixed[2 * vary:2 * vary + 2] = False
        words[fixed] = words[fixed][:, :1]
        words[2 * vary + 1, ::2] |= 1 << 31
    words[7] %= TOP
    words = np.unique(words.astype(np.uint32), axis=1)
    return words[:, rng.permutation(words.shape[1])]


def _mont(words):
    return limbs.to_mont(FR, limbs.to_device(words, "cpu"))


def _case(kind, rng):
    """(table, inputs) raw words (8, N) for one lookup argument."""
    pool = _pool(rng, 96, int(kind[3]) if kind.endswith("_only") else None)
    n_inputs = 3 if kind == "three_inputs" else 1
    if kind == "one_value":
        t_idx = np.zeros(N, int)
    elif kind == "only_duplicated":
        # table values 0-29 once each, 30-39 several times; inputs hit the latter
        t_idx = np.concatenate([np.arange(30), rng.integers(30, 40, N - 30)])
        t_idx = t_idx[rng.permutation(N)]
    else:
        t_idx = rng.integers(0, 40, N)           # many duplicates
    table = pool[:, t_idx]
    present = np.unique(t_idx[:A])
    if kind == "only_duplicated":
        present = present[present >= 30]
    inputs = []
    for _ in range(n_inputs):
        f = pool[:, rng.choice(present, N)]
        if kind == "past_a":
            f[:, A:] = pool[:, 50:50 + N - A]    # not in the table: ignored
            table[:, A:] = pool[:, 90:91]
        inputs.append(f)
    return table, inputs


@pytest.mark.parametrize("kind", ["duplicates", "one_value", "only_duplicated",
                                  "three_inputs", "past_a", "key0_only", "key1_only",
                                  "key2_only", "key3_only"])
def test_device_count_equals_host_count(kind):
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    table, inputs = _case(kind, rng)
    t, fs = _mont(table), [_mont(f) for f in inputs]
    m = prover.lookup_multiplicities(kind, t, fs, A, N)
    assert m.dtype == torch.int64 and m.shape == (N,)
    np.testing.assert_array_equal(m.numpy(), _host_m(kind, t, fs, A, N))
    assert int(m.sum()) == A * len(fs)


@pytest.mark.parametrize("where", ["absent", "past_a"])
def test_missing_input_values_raise_with_their_count(where):
    """Inputs whose value no table row [:a] holds raise, counted as the
    host count counts them; a value only in table rows a.. is missing."""
    rng = np.random.default_rng(7)
    pool = _pool(rng, 64)
    table = pool[:, rng.integers(0, 40, N)]
    table[:, A:] = pool[:, 45:46]
    f = table[:, rng.integers(0, A, N)]
    bad = [3, 17, 100, 229]
    f[:, bad] = pool[:, 50:51] if where == "absent" else pool[:, 45:46]
    t, fs = _mont(table), [_mont(f)]
    with pytest.raises(ValueError, match="input values not in table") as want:
        _host_m("lk", t, fs, A, N)
    with pytest.raises(ValueError) as got:
        prover.lookup_multiplicities("lk", t, fs, A, N)
    assert str(got.value) == str(want.value) == "lookup 'lk': 4 input values not in table"


def test_proof_reports_the_rows_counted():
    """A K=4 proof with one single-input lookup fills LOOKUP_ROWS with its
    active rows and verifies."""
    build, fill = circuits.CIRCUITS["mul_lookup"]
    system, cols = build(cs)
    asg = fill(system, cols, Assignment)
    srs = srsmod.gen_srs(circuits.K, device="cpu")
    pk = keygen.keygen(system, circuits.K, srs, asg, device="cpu")
    prover.LOOKUP_ROWS["stale"] = 1
    proof = prover.create_proof(pk, srs, asg, seed=5)
    a = prover._kernels(pk).a
    assert prover.LOOKUP_ROWS == {"lookups": 1, "table_rows": a, "input_rows": a}
    assert verifier.verify(pk.vk, srs.g2, srs.s_g2, proof)

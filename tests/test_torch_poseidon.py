"""The port's Poseidon (`ezkl_tpu_torch/kernels/poseidon.py`) against the JAX
package's host functions (`ezkl_tpu.kernels.poseidon`), on the CPU.

Tolerances: the parameters (round constants, MDS) equal; every host
permutation, trace and hash equal as integers; the device sponge
(`hash_fixed_len`, whose products are K1 calls: the plain version here)
bit-exact against the reference's `host_hash`. Inputs are seeded field
elements from numpy."""

import numpy as np
import pytest
import torch

from ezkl_tpu.kernels import poseidon as ref
from ezkl_tpu_torch.fieldmath import limbs
from ezkl_tpu_torch.kernels import poseidon as pos

FR = pos.bn254_fr()
P = FR.modulus
torch.set_num_threads(1)     # small tensors; pytest-xdist runs one worker per core


def _felts(rng, *shape):
    flat = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(int(np.prod(shape)))]
    return np.asarray(flat, dtype=object).reshape(shape)


def test_parameters_equal_the_reference():
    """The interop constants of the (BN254 Fr, t = 2, 8 + 56 rounds) sponge."""
    assert pos.generate_parameters() == ref.generate_parameters()
    rc, mds = pos.generate_parameters()
    assert len(rc) == pos.FULL_ROUNDS + pos.PARTIAL_ROUNDS and len(mds) == pos.WIDTH


def test_grain_parameters_equal_the_reference():
    """A configuration off the interop one is derived with the Grain LFSR."""
    args = (P, 3, 8, 5)
    assert pos.generate_parameters(*args) == ref.generate_parameters(*args)


@pytest.mark.parametrize("length", [1, 2, 5])
def test_host_hash_and_traces_equal_the_reference(length):
    rng = np.random.default_rng(length)
    xs = [int(v) for v in _felts(rng, length)]
    assert pos.host_hash(xs) == ref.host_hash(xs)
    state = xs[:2] if length > 1 else [xs[0], 0]
    assert pos.host_permute(state) == ref.host_permute(state)
    assert pos.host_permute_trace(state) == ref.host_permute_trace(state)
    assert pos.host_sponge_traces(xs) == ref.host_sponge_traces(xs)


@pytest.mark.parametrize("length, batch", [(1, 3), (2, 4), (3, 2)])
def test_device_hash_fixed_len_equals_the_reference_host_hash(length, batch):
    """(8, L, batch) Montgomery inputs on the CPU tensor route."""
    rng = np.random.default_rng(10 * length + batch)
    xs = _felts(rng, batch, length)
    inputs = limbs.to_device(limbs.encode(FR, xs), "cpu").movedim(1, 2)
    out = limbs.decode(FR, pos.hash_fixed_len(FR, inputs))
    assert [int(v) for v in out] == [ref.host_hash([int(v) for v in row]) for row in xs]


def test_device_permute_equals_the_reference_host_permute():
    rng = np.random.default_rng(7)
    states = _felts(rng, 3, pos.WIDTH)
    out = pos.permute(FR, limbs.to_device(limbs.encode(FR, states), "cpu").movedim(1, 2))
    got = limbs.decode(FR, out.movedim(2, 1))
    for row, want in zip(got, states):
        assert [int(v) for v in row] == ref.host_permute([int(v) for v in want])

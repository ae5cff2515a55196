"""Poseidon hash over BN254 Fr, parameters derived via the Grain LFSR (port
of `ezkl_tpu/kernels/poseidon.py`).

Parity target: the reference's PoseidonChip/PoseidonSpec
(`ezkl/src/circuit/modules/poseidon/spec.rs`: WIDTH=2, RATE=1,
8 full rounds, 56 partial rounds, x^5 sbox) whose constants were produced by
the public pasta-hadeshash `generate_parameters_grain.sage` script. We
re-derive the round constants and MDS from scratch with the published Grain
LFSR algorithm (Poseidon paper, §"Instantiating the round constants") —
nothing is copied from the reference tables.

Device sponge: batched over (8, batch) Montgomery limb lanes. The x^5 sbox
is 3 Montgomery products; each round adds constants, sboxes (full: all
lanes, partial: lane 0 only) and applies the 2x2 MDS (one product of the
state against the matrix) -- all batched over the hash batch, so hashing N
messages costs the same depth as one. The JAX package runs these as jnp
code (no Pallas site); here every product is a K1 call (`limbs.mont_mul`),
a launch of `ez_mont_mul` on the card.
"""

from __future__ import annotations

import functools

import torch

from ..fieldmath import limbs
from ..fieldmath.spec import FieldSpec, bn254_fr, NWORDS

WIDTH = 2
RATE = 1
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 56


# ---------------------------------------------------------------------------
# Grain LFSR parameter generation (host, bigint)
# ---------------------------------------------------------------------------

class _Grain:
    """Grain LFSR from the Poseidon reference parameter generator."""

    def __init__(self, field_tag: int, sbox_tag: int, n: int, t: int, r_f: int, r_p: int):
        bits = []
        for val, width in ((field_tag, 2), (sbox_tag, 4), (n, 12), (t, 12), (r_f, 10), (r_p, 10)):
            bits += [int(b) for b in format(val, f"0{width}b")]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._raw_bit()

    def _raw_bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def bit(self) -> int:
        # self-shrinking: emit the bit after a 1, skip the bit after a 0
        while True:
            if self._raw_bit() == 1:
                return self._raw_bit()

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def field_element(self, n_bits: int, p: int) -> int:
        while True:
            v = self.bits(n_bits)
            if v < p:
                return v


@functools.lru_cache(maxsize=4)
def generate_parameters(p: int = bn254_fr().modulus, t: int = WIDTH,
                        r_f: int = FULL_ROUNDS, r_p: int = PARTIAL_ROUNDS):
    """Returns (round_constants [(r_f+r_p) x t], mds [t x t]) as int lists.

    For the reference-compatible config (BN254 Fr, t=2, 8/56) the standard
    public interop constants are loaded from `poseidon_constants.json`
    (extracted by `tools/extract_poseidon_params.py`). Other configs are
    derived with the Grain LFSR.
    """
    if (p, t, r_f, r_p) == (bn254_fr().modulus, 2, 8, 56):
        import json
        import pathlib

        path = pathlib.Path(__file__).parent / "poseidon_constants.json"
        data = json.loads(path.read_text())
        rc = [[int(c, 16) for c in row] for row in data["round_constants"]]
        mds = [[int(c, 16) for c in row] for row in data["mds"]]
        return rc, mds
    n_bits = p.bit_length()  # 254
    g = _Grain(field_tag=1, sbox_tag=0, n=n_bits, t=t, r_f=r_f, r_p=r_p)
    rc = [[g.field_element(n_bits, p) for _ in range(t)] for _ in range(r_f + r_p)]
    # Cauchy MDS: M[i][j] = 1/(x_i + y_j) with xs, ys drawn from the stream
    xs = [g.field_element(n_bits, p) for _ in range(t)]
    ys = [g.field_element(n_bits, p) for _ in range(t)]
    mds = [[pow((x + y) % p, -1, p) for y in ys] for x in xs]
    return rc, mds


# ---------------------------------------------------------------------------
# host reference permutation / hash (bigint, test oracle + transcripts)
# ---------------------------------------------------------------------------

def host_permute(state: list[int], p: int | None = None) -> list[int]:
    p = p or bn254_fr().modulus
    rc, mds = generate_parameters(p)
    t = len(state)
    r_f_half = FULL_ROUNDS // 2
    s = list(state)
    rnd = 0

    def sbox(x):
        return pow(x, 5, p)

    def mix(s):
        return [sum(mds[i][j] * s[j] for j in range(t)) % p for i in range(t)]

    for _ in range(r_f_half):
        s = [(x + rc[rnd][i]) % p for i, x in enumerate(s)]
        s = [sbox(x) for x in s]
        s = mix(s)
        rnd += 1
    for _ in range(PARTIAL_ROUNDS):
        s = [(x + rc[rnd][i]) % p for i, x in enumerate(s)]
        s[0] = sbox(s[0])
        s = mix(s)
        rnd += 1
    for _ in range(r_f_half):
        s = [(x + rc[rnd][i]) % p for i, x in enumerate(s)]
        s = [sbox(x) for x in s]
        s = mix(s)
        rnd += 1
    return s


def host_permute_trace(state: list[int], p: int | None = None) -> list[list[int]]:
    """All 65 states (initial + after each round) — for in-circuit layout."""
    p = p or bn254_fr().modulus
    rc, mds = generate_parameters(p)
    t = len(state)
    half = FULL_ROUNDS // 2
    s = list(state)
    trace = [list(s)]

    def rnd(s, i, partial):
        s = [(x + rc[i][j]) % p for j, x in enumerate(s)]
        s = [pow(s[0], 5, p)] + ([pow(x, 5, p) for x in s[1:]] if not partial else s[1:])
        return [sum(mds[a][b] * s[b] for b in range(t)) % p for a in range(t)]

    i = 0
    for _ in range(half):
        s = rnd(s, i, False); trace.append(list(s)); i += 1
    for _ in range(PARTIAL_ROUNDS):
        s = rnd(s, i, True); trace.append(list(s)); i += 1
    for _ in range(half):
        s = rnd(s, i, False); trace.append(list(s)); i += 1
    return trace


def host_sponge_traces(inputs, p: int | None = None):
    """Whole-sponge trace for in-circuit layout, one tight specialized loop.

    Returns `(traces, absorbed)` where `traces[i]` is the (rounds+1, 2)
    per-round state list of permutation i and `absorbed[i]` is the s0 input
    of permutation i *after* the rate-element add. Width-2 unrolled: ~3x
    faster per permutation than the generic `host_permute_trace`, and the
    caller lays ALL permutations in one batched pass (no per-element layout
    loop), hashed visibility's hot spot. Oracle parity with `host_hash` is
    asserted in tests/test_torch_poseidon.py."""
    p = p or bn254_fr().modulus
    rc, mds = generate_parameters(p)
    m00, m01 = mds[0][0], mds[0][1]
    m10, m11 = mds[1][0], mds[1][1]
    half = FULL_ROUNDS // 2
    L = len(inputs)
    s0, s1 = 0, (L << 64) % p
    traces, absorbed = [], []
    for x in inputs:
        s0 = (s0 + x) % p
        absorbed.append(s0)
        tr = [(s0, s1)]
        rnd = 0
        for seg, partial in ((half, False), (PARTIAL_ROUNDS, True), (half, False)):
            for _ in range(seg):
                c0, c1 = rc[rnd]
                a = pow((s0 + c0) % p, 5, p)
                b = (s1 + c1) % p
                if not partial:
                    b = pow(b, 5, p)
                s0 = (m00 * a + m01 * b) % p
                s1 = (m10 * a + m11 * b) % p
                tr.append((s0, s1))
                rnd += 1
        traces.append(tr)
    return traces, absorbed


def host_hash(inputs: list[int], p: int | None = None) -> int:
    """Sponge with rate=1, width=2, ConstantLength<L> domain (halo2_gadgets):
    initial capacity = 2^64 * L ... see test for cross-check."""
    p = p or bn254_fr().modulus
    L = len(inputs)
    state = [0, (L << 64) % p]
    for x in inputs:
        state[0] = (state[0] + x) % p
        state = host_permute(state, p)
    return state[0]


# ---------------------------------------------------------------------------
# device sponge (batched)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _device_constants(spec: FieldSpec, device: str):
    """Round constants (R, 8, t) and MDS (8, t, t), Montgomery, on `device`."""
    rc, mds = generate_parameters(spec.modulus)
    rc_dev = limbs.to_device(limbs.encode(spec, rc), device).movedim(1, 0).contiguous()
    mds_dev = limbs.to_device(limbs.encode(spec, mds), device)
    return rc_dev, mds_dev


def _sbox(spec, x):
    x2 = limbs.mont_mul(spec, x, x)
    x4 = limbs.mont_mul(spec, x2, x2)
    return limbs.mont_mul(spec, x4, x)


def _mix(spec, s, mds):
    """s: (8, t, *B); mds: (8, t, t). out[i] = sum_j mds[i,j] * s[j]: one
    product of the state (broadcast over i) against the matrix (broadcast
    over the batch)."""
    t = s.shape[1]
    batch_nd = s.dim() - 2
    prods = limbs.mont_mul(spec, s[:, None], mds.reshape((NWORDS, t, t) + (1,) * batch_nd))
    acc = prods[:, :, 0]
    for j in range(1, t):
        acc = limbs.add(spec, acc, prods[:, :, j])
    return acc


def permute(spec: FieldSpec, state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation. state: (8, t, *batch) Montgomery -> same shape.

    Round structure matches halo2_gadgets Pow5: r_f/2 full rounds, r_p
    partial rounds (rc added to ALL words, sbox on word 0 only), r_f/2 full
    rounds; MDS mix after every round."""
    rc, mds = _device_constants(spec, str(state.device))
    batch_nd = state.dim() - 2
    half = FULL_ROUNDS // 2
    for r in range(FULL_ROUNDS + PARTIAL_ROUNDS):
        s = limbs.add(spec, state, rc[r].reshape(rc[r].shape + (1,) * batch_nd))
        if half <= r < half + PARTIAL_ROUNDS:
            s = torch.cat([_sbox(spec, s[:, :1]), s[:, 1:]], dim=1)
        else:
            s = _sbox(spec, s)
        state = _mix(spec, s, mds)
    return state


def hash_fixed_len(spec: FieldSpec, inputs: torch.Tensor) -> torch.Tensor:
    """Batched fixed-length sponge hash. inputs: (8, L, *batch) Montgomery
    limbs -> (8, *batch). RATE=1 absorb: s[0] += x_i; permute; repeat;
    squeeze s[0]. Initial capacity = L << 64 (halo2_gadgets ConstantLength)."""
    L = inputs.shape[1]
    batch = tuple(inputs.shape[2:])
    dev = inputs.device
    cap = limbs.bcast_const(spec, (L << 64) % spec.modulus, len(batch), device=dev)
    state = torch.stack([limbs.zeros(batch, dev), cap.expand((NWORDS,) + batch)], dim=1)
    for i in range(L):
        s0 = limbs.add(spec, state[:, :1], inputs[:, i:i + 1])
        state = permute(spec, torch.cat([s0, state[:, 1:]], dim=1))
    return state[:, 0]

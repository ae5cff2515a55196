"""Fiat-Shamir transcripts (port of `ezkl_tpu/plonk/transcript.py`).

Byte-level protocol, identical to the JAX package's:

* absorb a G1 point: 32-byte LE x || 32-byte LE y (affine, identity = 0||0)
* absorb an Fr scalar: 32-byte LE
* challenge: hash(state || b"\\x00") -> 64 bytes -> int LE mod r; the state
  then absorbs the challenge bytes (domain-separated chaining).

`EvmTranscript` is the keccak, big-endian variant that the generated
Solidity verifier replays.

Host-side (a few KB per proof).
"""

from __future__ import annotations

import hashlib

from ..fieldmath import curve, limbs
from ..fieldmath.spec import FR_MODULUS, bn254_fr
from ..utils.keccak import keccak256

FR = bn254_fr()


class Transcript:
    def __init__(self, label: bytes = b"ezkl-tpu-proof"):
        self._state = bytes(hashlib.blake2b(label, digest_size=64).digest())

    def _hash(self, data: bytes) -> bytes:
        return hashlib.blake2b(data, digest_size=64).digest()

    # -- absorbing ----------------------------------------------------------

    def common_bytes(self, data: bytes):
        self._state = self._hash(self._state + b"\x01" + data)

    def common_scalar(self, x: int):
        self.common_bytes(int(x % FR_MODULUS).to_bytes(32, "little"))

    def common_point(self, pt):
        """pt: host (x, y) ints or None (identity)."""
        if pt is None:
            self.common_bytes(b"\x00" * 64)
        else:
            self.common_bytes(
                int(pt[0]).to_bytes(32, "little") + int(pt[1]).to_bytes(32, "little")
            )

    # -- challenges ---------------------------------------------------------

    def challenge(self) -> int:
        out = self._hash(self._state + b"\x00")
        self._state = self._hash(self._state + b"\x02" + out)
        return int.from_bytes(out, "little") % FR_MODULUS


class KeccakTranscript(Transcript):
    def __init__(self, label: bytes = b"ezkl-tpu-proof"):
        self._state = keccak256(label)

    def _hash(self, data: bytes) -> bytes:
        # two squeezes for 64 bytes of output material
        h1 = keccak256(data)
        return h1 + keccak256(h1 + data)


class EvmTranscript:
    """EVM-native transcript: keccak256 state chaining, 32-byte BIG-endian
    encodings, single-squeeze challenges -- what the generated Solidity
    verifier replays.

    absorb:    state = keccak256(state || 0x01 || data)
    challenge: out = keccak256(state || 0x00); state = keccak256(state ||
               0x02 || out); value = int_be(out) mod r
    """

    def __init__(self, label: bytes = b"ezkl-tpu-evm"):
        self._state = keccak256(label)

    def common_bytes(self, data: bytes):
        self._state = keccak256(self._state + b"\x01" + data)

    def common_scalar(self, x: int):
        self.common_bytes(int(x % FR_MODULUS).to_bytes(32, "big"))

    def common_point(self, pt):
        if pt is None:
            self.common_bytes(b"\x00" * 64)
        else:
            self.common_bytes(int(pt[0]).to_bytes(32, "big")
                              + int(pt[1]).to_bytes(32, "big"))

    def challenge(self) -> int:
        out = keccak256(self._state + b"\x00")
        self._state = keccak256(self._state + b"\x02" + out)
        return int.from_bytes(out, "big") % FR_MODULUS


def decode_point_host(pt: curve.PointP):
    """Device PointP (batch ()) -> host affine tuple or None."""
    batched = curve.PointP(pt.x[:, None], pt.y[:, None], pt.z[:, None])
    return curve.decode_points(batched)[0]


def decode_scalar_host(v) -> int:
    """Device (8,) Montgomery limb scalar -> host int."""
    return int(limbs.decode(FR, limbs.host_words(v)[:, None])[0])

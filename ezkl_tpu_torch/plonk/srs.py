"""KZG structured reference strings (port of `gen_srs` of
`ezkl_tpu/plonk/srs.py`).

`gen_srs` creates the same INSECURE deterministic SRS as the JAX package
(tau derived from a seed, `srs.py:59-80`): tau^i scalars, then one batched
double-and-add scalar multiplication of the generator on the device, then
normalization to affine (z = 1).
"""

from __future__ import annotations

import dataclasses
import hashlib

from ..fieldmath import limbs, curve
from ..fieldmath.spec import bn254_fr, FR_MODULUS
from . import pairing


@dataclasses.dataclass
class SRS:
    """g1[i] = tau^i * G1 (i < 2^k) as a batched device PointP; g2 powers
    [G2, tau*G2] as host affine Fq2 pairs."""

    k: int
    g1: curve.PointP          # batch (n,)
    g2: tuple                 # G2 generator (host)
    s_g2: tuple               # tau * G2 (host)

    @property
    def n(self) -> int:
        return 1 << self.k


def gen_srs(k: int, seed: bytes = b"ezkl-tpu insecure srs", device=None) -> SRS:
    """INSECURE deterministic SRS (tau derived from seed). Test/dev only."""
    tau = int.from_bytes(hashlib.blake2b(seed, digest_size=32).digest(), "little") % FR_MODULUS
    n = 1 << k
    fr = bn254_fr()
    dev = limbs.device_of(device)
    powers_raw = limbs.from_mont(fr, limbs.powers(fr, tau, n, dev))
    bits = curve.scalars_to_bits(powers_raw)                   # (256, n)
    g1 = curve.scalar_mul(curve.generator((n,), dev), bits)
    ax, ay = curve.to_affine(g1)
    g1 = curve.from_affine(ax, ay)
    g2 = pairing.G2_GEN
    s_g2 = pairing.g2_mul(g2, tau)
    return SRS(k=k, g1=g1, g2=g2, s_g2=s_g2)

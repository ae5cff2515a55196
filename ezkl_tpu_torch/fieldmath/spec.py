"""BN254 field specifications (copy of `ezkl_tpu.fieldmath.spec`).

The constants are the same as the JAX package's: Montgomery form with
R = 2^256, so a Montgomery integer is the same number in both packages.
The 16-bit limb helpers below describe the JAX package's layout
(`(16, *batch)` u32); the port stores 8 limbs of 32 bits
(`(8, *batch)` int32, see `ezkl_tpu_torch.fieldmath.limbs`) and uses the
32-bit helpers at the end of this module.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

LIMB_BITS = 16
NLIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
TOTAL_BITS = LIMB_BITS * NLIMBS  # 256


def int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    """Python int -> (n,) uint32 little-endian 16-bit limbs."""
    assert 0 <= x < (1 << (LIMB_BITS * n)), "value out of range"
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)], dtype=np.uint32)


def limbs_to_int(a) -> int:
    """(n,) limb vector -> Python int."""
    a = np.asarray(a)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(a))


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: usable as jit static arg
class FieldSpec:
    """All constants needed for Montgomery arithmetic mod `modulus`."""

    name: str
    modulus: int
    # Montgomery: R = 2^256 mod p
    r: int
    r2: int              # R^2 mod p
    r3: int              # R^3 mod p
    n0: int              # -p^{-1} mod 2^16 (per-limb Montgomery factor)
    mod_limbs: np.ndarray
    r_limbs: np.ndarray
    r2_limbs: np.ndarray
    # multiplicative generator & 2-adic root of unity (0 if not computed)
    generator: int = 0
    two_adicity: int = 0
    root_of_unity: int = 0  # order 2^two_adicity

    @property
    def zero_int(self) -> int:
        return 0

    def to_mont_int(self, x: int) -> int:
        return (x * self.r) % self.modulus

    def from_mont_int(self, x: int) -> int:
        rinv = pow(self.r, -1, self.modulus)
        return (x * rinv) % self.modulus


def _make_spec(name: str, p: int, generator: int = 0) -> FieldSpec:
    R = (1 << TOTAL_BITS) % p
    R2 = (R * R) % p
    R3 = (R2 * R) % p
    n0 = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    two_adicity = 0
    root = 0
    if generator:
        t = p - 1
        while t % 2 == 0:
            t //= 2
            two_adicity += 1
        root = pow(generator, (p - 1) >> two_adicity, p)
    return FieldSpec(
        name=name,
        modulus=p,
        r=R,
        r2=R2,
        r3=R3,
        n0=n0,
        mod_limbs=int_to_limbs(p),
        r_limbs=int_to_limbs(R),
        r2_limbs=int_to_limbs(R2),
        generator=generator,
        two_adicity=two_adicity,
        root_of_unity=root,
    )


# BN254 (alt_bn128) base field Fq: y^2 = x^3 + 3 lives over this.
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# BN254 scalar field Fr (circuit field): 2-adicity 28, generator 7.
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617


@functools.lru_cache(maxsize=None)
def bn254_fq() -> FieldSpec:
    return _make_spec("bn254_fq", FQ_MODULUS, generator=3)


@functools.lru_cache(maxsize=None)
def bn254_fr() -> FieldSpec:
    return _make_spec("bn254_fr", FR_MODULUS, generator=7)


# the port's layout: 8 little-endian limbs of 32 bits
WORD_BITS = 32
NWORDS = 8
WORD_MASK = (1 << WORD_BITS) - 1


def int_to_words(x: int, n: int = NWORDS) -> np.ndarray:
    """Python int -> (n,) uint32 little-endian 32-bit limbs."""
    assert 0 <= x < (1 << (WORD_BITS * n)), "value out of range"
    return np.array([(x >> (WORD_BITS * i)) & WORD_MASK for i in range(n)],
                    dtype=np.uint32)

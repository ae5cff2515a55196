"""Host-side (Python bigint) BN254 G1/G2 reference arithmetic.

Ground truth for kernel tests, and the generator for small SRS / G2 points
(the device path never needs G2). Affine coordinates with explicit
special cases — clarity over speed.
"""

from __future__ import annotations

from .spec import FQ_MODULUS as P, FR_MODULUS as R

# G2 generator (standard BN254/alt_bn128 values), coordinates in Fq2 = Fq[u]/(u^2+1)
G2_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

G1 = (1, 2)


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % P)


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(p):
    return g1_add(p, p)


def g1_mul(p, k: int):
    k %= R
    from . import native
    if native.available():
        return native.g1_mul(p, k)
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_add(p, p)
        k >>= 1
    return acc


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 3) % P == 0


def g1_msm(points, scalars):
    """Host MSM (native when built; Python-bigint oracle otherwise)."""
    from . import native
    if native.available():
        return native.g1_msm(list(points), [s % R for s in scalars])
    acc = None
    for pt, s in zip(points, scalars):
        if pt is None or s % R == 0:
            continue
        acc = g1_add(acc, g1_mul(pt, s))
    return acc

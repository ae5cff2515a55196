"""BN254 in plain Python integers: the two prime fields, the G1 group law in
Jacobian coordinates, and the roots of unity of the scalar field. The
benchmark's reference verifier rests on these; they import nothing of the
program.
"""

from __future__ import annotations

# base field q and scalar field r of BN254 (alt_bn128, EIP-196)
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
G1 = (1, 2)                     # y^2 = x^3 + 3
FR_GENERATOR = 7                # a multiplicative generator of Fr*
FR_TWO_ADICITY = 28


def root_of_unity(k: int) -> int:
    """A primitive 2^k-th root of unity of Fr: the generator raised to
    (r - 1) / 2^k."""
    assert 0 <= k <= FR_TWO_ADICITY
    return pow(FR_GENERATOR, (R - 1) >> k, R)


def on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return 0 <= x < Q and 0 <= y < Q and (y * y - x * x * x - 3) % Q == 0


# Jacobian points (X, Y, Z) with x = X / Z^2, y = Y / Z^3; Z = 0 is the identity

def _jac(p):
    return (0, 1, 0) if p is None else (p[0], p[1], 1)


def _dbl(p):
    x, y, z = p
    if z == 0 or y == 0:
        return (0, 1, 0)
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return (x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q)


def _add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        return _dbl(p) if s1 == s2 else (0, 1, 0)
    h = (u2 - u1) % Q
    rr = (s2 - s1) % Q
    hh = h * h % Q
    hhh = h * hh % Q
    v = u1 * hh % Q
    x3 = (rr * rr - hhh - 2 * v) % Q
    return (x3, (rr * (v - x3) - s1 * hhh) % Q, z1 * z2 * h % Q)


def _affine(p):
    if p[2] == 0:
        return None
    zi = pow(p[2], -1, Q)
    zi2 = zi * zi % Q
    return (p[0] * zi2 % Q, p[1] * zi2 * zi % Q)


def mul(p, k: int):
    """[k]p."""
    return lincomb([(p, k)])


def lincomb(terms):
    """sum of s_i * P_i over (point, scalar) pairs."""
    acc = (0, 1, 0)
    for p, s in terms:
        s %= R
        base = _jac(p)
        part = (0, 1, 0)
        while s:
            if s & 1:
                part = _add(part, base)
            base = _dbl(base)
            s >>= 1
        acc = _add(acc, part)
    return _affine(acc)

"""Host-side BN254 (alt_bn128) optimal ate pairing over Python bigints.

Used ONLY by the verifier (two pairings per KZG check) and by tests —
proving never needs pairings, so this stays host code by design; the
reference's analog lives in halo2curves (SURVEY.md §2.1).

Tower: Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - xi), xi = 9+u;
Fq12 = Fq6[w]/(w^2 - v). Standard optimal ate with 6t+2 Miller loop and
hard-part final exponentiation by total exponent (simple, a few ms).
"""

from __future__ import annotations

from ..fieldmath.spec import FQ_MODULUS as P
from ..fieldmath.hostcurve import G1, G2_X, G2_Y

# curve params
BN_T = 4965661367192848881          # BN parameter t
ATE_LOOP = 6 * BN_T + 2             # 29793968203157093288


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_scalar(a, k):
    return ((a[0] * k) % P, (a[1] * k) % P)


def f2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return ((a[0] * d) % P, (-a[1] * d) % P)


def f2_conj(a):
    return (a[0], (-a[1]) % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # nonresidue for Fq6


# ---------------------------------------------------------------------------
# Fq6 = (c0, c1, c2) over Fq2; v^3 = XI
# ---------------------------------------------------------------------------

def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def _mul_xi(a):
    return f2_mul(a, XI)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, _mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), _mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_by_v(a):
    # v * (a0 + a1 v + a2 v^2) = xi*a2 + a0 v + a1 v^2
    return (_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a2, _mul_xi(c1)), f2_add(f2_mul(a0, c0), _mul_xi(f2_mul(a1, c2))))
    tinv = f2_inv(t)
    return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


# ---------------------------------------------------------------------------
# Fq12 = (c0, c1) over Fq6; w^2 = v
# ---------------------------------------------------------------------------

def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_by_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_inv(a):
    a0, a1 = a
    t = f6_inv(f6_sub(f6_mul(a0, a0), f6_mul_by_v(f6_mul(a1, a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


F12_ONE = (F6_ONE, F6_ZERO)


def f12_pow(a, e):
    r = F12_ONE
    base = a
    while e:
        if e & 1:
            r = f12_mul(r, base)
        base = f12_sqr(base)
        e >>= 1
    return r


# ---------------------------------------------------------------------------
# G2 arithmetic (affine over Fq2)
# ---------------------------------------------------------------------------

def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(p):
    if p is None:
        return None
    return (p[0], f2_neg(p[1]))


def g2_mul(p, k):
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_add(p, p)
        k >>= 1
    return acc


G2_GEN = (G2_X, G2_Y)

# b coefficient of the twist: y^2 = x^3 + 3/xi
B2 = f2_mul((3, 0), f2_inv(XI))


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return f2_sub(f2_sqr(y), f2_mul(f2_sqr(x), x)) == B2


# ---------------------------------------------------------------------------
# Miller loop (optimal ate)
# ---------------------------------------------------------------------------

def _line(pq, r, pt):
    """Line through pq and r (or tangent if equal), evaluated at G1 point pt.

    pq, r: G2 affine points (twist coords). pt: (x, y) in Fq.
    Returns sparse Fq12 element. Uses the D-type twist embedding: the G2
    point (x', y') maps to (x' w^2, y' w^3) in Fq12.
    """
    (x1, y1), (x2, y2) = pq, r
    px, py = pt
    if x1 == x2 and y1 == y2:
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    elif x1 == x2:
        # vertical line x - x1, at the embedded point: px - x1*w^2
        return (((px % P, 0), f2_neg(x1), F2_ZERO), F6_ZERO)
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    # Embedded slope is w*lam (twist slope lam), so the line through the
    # embedded T at the G1 point (px, py) is
    #   py  +  [-lam*px] w  +  [lam*x1 - y1] w^3,     w^3 = v*w
    c0 = (((py % P), 0), F2_ZERO, F2_ZERO)
    c1 = (f2_neg(f2_scalar(lam, px)), f2_sub(f2_mul(lam, x1), y1), F2_ZERO)
    return (c0, c1)


def _frob_coeffs():
    # gamma12 = xi^((p-1)/3), gamma13 = xi^((p-1)/2) in Fq2
    e3 = (P - 1) // 3
    e2 = (P - 1) // 2
    def f2_pow(a, e):
        r = F2_ONE
        while e:
            if e & 1:
                r = f2_mul(r, a)
            a = f2_sqr(a)
            e >>= 1
        return r
    return f2_pow(XI, e3), f2_pow(XI, e2)


_G12, _G13 = _frob_coeffs()


def g2_frobenius(q):
    """psi(Q) = (x^p * gamma12, y^p * gamma13) on the twist."""
    x, y = q
    return (f2_mul(f2_conj(x), _G12), f2_mul(f2_conj(y), _G13))


def miller_loop(q, p1) -> tuple:
    """f_{6t+2, Q}(P) with the two frobenius correction lines."""
    if q is None or p1 is None:
        return F12_ONE
    f = F12_ONE
    t = q
    naf_e = ATE_LOOP
    bits = bin(naf_e)[3:]  # skip leading 1
    for b in bits:
        f = f12_mul(f12_sqr(f), _line(t, t, p1))
        t = g2_add(t, t)
        if b == "1":
            f = f12_mul(f, _line(t, q, p1))
            t = g2_add(t, q)
    # frobenius corrections
    q1 = g2_frobenius(q)
    q2 = g2_neg(g2_frobenius(q1))
    f = f12_mul(f, _line(t, q1, p1))
    t = g2_add(t, q1)
    f = f12_mul(f, _line(t, q2, p1))
    return f


def final_exponentiation(f):
    """f^((p^12 - 1) / r)."""
    from ..fieldmath.spec import FR_MODULUS as R
    e = (P ** 12 - 1) // R
    return f12_pow(f, e)


def pairing(p1, q2):
    """e(P, Q) for P in G1 (affine int pair / None), Q in G2."""
    if p1 is None or q2 is None:
        return F12_ONE
    return final_exponentiation(miller_loop(q2, p1))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 (native C++ path when built; ~8x)."""
    from ..fieldmath import native
    if native.available():
        return native.pairing_check(pairs)
    f = F12_ONE
    for p1, q2 in pairs:
        if p1 is None or q2 is None:
            continue
        f = f12_mul(f, miller_loop(q2, p1))
    return final_exponentiation(f) == F12_ONE

"""The work an ideal prover of a keyed circuit does, counted from the
circuit's shapes alone, and the card's peaks that the work is held against.

The shapes are k, the extended k, the number of columns of each kind, the
lookup, shuffle and permutation arguments and the gate expressions, read
from the keyed circuit by `shapes`. Nothing here reads the program's launch
counters, so the counts do not move when the program's kernels do.

The ideal prover keeps the fixed and permutation columns' extended forms in
its key, as halo2's does, so it transforms only what a proof commits. Every
count is of Montgomery products of 254-bit field elements; each costs
`IMAD_PER_PRODUCT` 32-bit integer multiply-adds.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM at its 700 W limit (data sheet; CUDA C++ Programming
# Guide, arithmetic throughput of compute capability 9.0): 132 SMs x 64
# 32-bit IMAD per clock x 1.98 GHz, and 3.35 TB/s of HBM3
IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# a 256-bit Montgomery product (8 x 8 words, CIOS): 128 32 x 32 -> 64-bit
# products at two IMADs each, and 8 for the reduction's low words
IMAD_PER_PRODUCT = 2 * 128 + 8
FR_BITS = 254
ELEMENT_BYTES = 32
# products of one point operation in Jacobian coordinates (a = 0):
# mixed addition madd-2007-bl 7M + 4S, addition add-2007-bl 11M + 5S,
# doubling dbl-2009-l 2M + 5S
MIXED_ADD = 11
FULL_ADD = 16
DOUBLE = 7
PERM_CHUNK = 6                 # permutation columns per grand product


def seconds_of(products: float) -> float:
    """The least time the card takes for `products` Montgomery products."""
    return products * IMAD_PER_PRODUCT / IMAD_PER_S


def shapes(vk) -> dict:
    """The shapes of the keyed circuit whose verifying key is `vk`."""
    cs = vk.cs
    return {
        "k": vk.k,
        "extended_k": vk.domain.extended_k,
        "num_fixed": cs.num_fixed,
        "num_advice": cs.num_advice,
        "num_instance": cs.num_instance,
        "lookups": [[len(tup) for tup in lk.inputs] + [len(lk.table)] for lk in cs.lookups],
        "shuffles": [len(sh.input) for sh in cs.shuffles],
        "perm_columns": len(cs.perm_columns),
        "gate_products": sum(_products(g.poly) for g in cs.gates),
        "gates": len(cs.gates),
        "rotations": sorted({q.rotation for q in _all_queries(cs)}),
        "queries": len({(q.column.kind, q.column.index, q.rotation)
                        for q in _all_queries(cs) if q.column.kind != "instance"}),
    }


def _products(e) -> int:
    kind = type(e).__name__
    if kind in ("Sum", "Product"):
        return (kind == "Product") + _products(e.a) + _products(e.b)
    if kind == "Scaled":
        return 1 + _products(e.a)
    return 0


def _all_queries(cs):
    out = []
    for g in cs.gates:
        out += g.poly.queries()
    for lk in cs.lookups:
        for e in [e for tup in lk.inputs for e in tup] + list(lk.table):
            out += e.queries()
    for sh in cs.shuffles:
        for e in tuple(sh.input) + tuple(sh.table):
            out += e.queries()
    return out


def window_bits(n: int) -> int:
    """Pippenger's window for n points: the c that minimises the
    products of `msm_products`."""
    return min(range(1, 25), key=lambda c: (_msm(n, c), c))


def _msm(n: int, c: int) -> int:
    windows = -(-FR_BITS // c)
    buckets = (1 << c) - 1
    return (windows * n * MIXED_ADD               # points into buckets
            + windows * 2 * buckets * FULL_ADD    # running sums over buckets
            + (windows - 1) * (c * DOUBLE + FULL_ADD))   # windows combined


def msm_products(n: int) -> int:
    """Products of one MSM of n affine points."""
    return _msm(n, window_bits(n))


def commitments(s: dict) -> int:
    """MSMs of 2^k points a proof makes: the advice columns, each lookup's
    multiplicities and grand sum, each permutation chunk's and shuffle's
    grand product, the random polynomial, the quotient's pieces and one
    opening witness per point opened."""
    chunks = -(-s["perm_columns"] // PERM_CHUNK)
    pieces = 1 << (s["extended_k"] - s["k"])
    return (s["num_advice"] + 2 * len(s["lookups"]) + chunks + len(s["shuffles"]) + 1
            + pieces + len(opening_points(s)))


def opening_points(s: dict) -> set:
    """The rotations at which the proof opens polynomials."""
    pts = set(s["rotations"]) | {0}
    if s["perm_columns"] or s["lookups"] or s["shuffles"]:
        pts.add(1)
    if s["perm_columns"] > PERM_CHUNK:
        pts.add(("last",))
    return pts


def transforms(s: dict) -> list:
    """(log2 size, count) of the transforms a proof needs: each committed
    Lagrange column to coefficients (size n) and to the extended coset
    (size n_ext), the random polynomial to coefficients, and the quotient
    back from the extended coset."""
    chunks = -(-s["perm_columns"] // PERM_CHUNK)
    cols = (s["num_advice"] + s["num_instance"] + 2 * len(s["lookups"]) + chunks
            + len(s["shuffles"]))
    return [(s["k"], cols + 1), (s["extended_k"], cols + 1)]


def ntt_products(log_n: int) -> int:
    """Butterfly products of one radix-2 transform of 2^log_n elements."""
    return (1 << log_n) // 2 * log_n


def ntt_seconds(log_n: int) -> float:
    """The least time of one transform of 2^log_n elements: its products
    or its elements read and written once, whichever bounds it."""
    return max(seconds_of(ntt_products(log_n)),
               2 * ELEMENT_BYTES * (1 << log_n) / HBM_BYTES_PER_S)


def msm_seconds(s: dict) -> float:
    return seconds_of(commitments(s) * msm_products(1 << s["k"]))


def transform_seconds(s: dict) -> float:
    return sum(count * ntt_seconds(log_n) for log_n, count in transforms(s))


def prove_products(s: dict) -> int:
    """Every Montgomery product of an ideal proof: the MSMs, the transforms
    and coset scalings, the quotient's terms on the extended coset, the
    grand products and sums on H, the evaluations and the openings."""
    n, n_ext = 1 << s["k"], 1 << s["extended_k"]
    chunks = -(-s["perm_columns"] // PERM_CHUNK)
    total = commitments(s) * msm_products(n)
    for log_n, count in transforms(s):
        total += count * (ntt_products(log_n) + (1 << log_n))
    # quotient on the extended coset: the gates' products, each permutation
    # column's two factors (beta * id, beta * sigma) and their running
    # products, each chunk's two sides, each lookup's compressions (theta)
    # and its six products, each shuffle's compressions and two sides; each
    # term folded in by y, and 1 / Z_H
    per_point = (s["gate_products"] + 4 * s["perm_columns"] + 3 * chunks
                 + sum(sum(lk) + 2 * len(lk) + 6 for lk in s["lookups"])
                 + sum(2 * w + 3 for w in s["shuffles"]))
    terms = s["gates"] + 3 * chunks + 3 * len(s["lookups"]) + 3 * len(s["shuffles"])
    total += (per_point + terms + 1) * n_ext
    # on H: the permutation's factors and batch inversion (3 products an
    # element) and running product; each lookup's inverses of its inputs
    # and table and the multiplicities' product; each shuffle's ratio
    total += n * (4 * s["perm_columns"] + 4 * chunks
                  + sum(3 * len(lk) + 1 for lk in s["lookups"])
                  + 5 * len(s["shuffles"]))
    # evaluations (Horner, n products a polynomial and point) and the
    # openings (the v-combination, n a polynomial and point; the division
    # by X - z, n a point)
    pairs = (s["queries"] + s["perm_columns"] + 2 * chunks + max(chunks - 1, 0)
             + 3 * len(s["lookups"]) + 2 * len(s["shuffles"]) + 1
             + (1 << (s["extended_k"] - s["k"])))
    total += n * (2 * pairs + len(opening_points(s)))
    return total


def share(ideal_s: float, measured_s: float):
    """ideal / measured in percent, or None where nothing was measured."""
    if not measured_s or measured_s <= 0 or math.isnan(measured_s):
        return None
    return 100.0 * ideal_s / measured_s

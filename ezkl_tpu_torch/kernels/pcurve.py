"""K3 (complete point add) and K9 (point doubling) over BN254 G1.

Replace the TPU kernels `_add_call` and `_dbl_call` of
`ezkl_tpu/kernels/pcurve.py` (entries `add` :722 and `dbl` :741). The CUDA
kernels (`csrc/curve.cu`) run RCB15 algorithms 7 and 9 in the lazy < 2p
domain and store canonical coordinates; the plain versions here run the
strict schedule of `ezkl_tpu.fieldmath.curve.add/dbl` on int64 words. Both
yield the same canonical projective triples.
"""

from __future__ import annotations

import torch

from ..fieldmath import limbs
from ..fieldmath.curve import PointP
from ..fieldmath.spec import bn254_fq, NWORDS
from . import build

FQ = bn254_fq()


def _mul(*pairs):
    """Independent products, batched into one plain multiply."""
    a = torch.stack([x for x, _ in pairs], dim=1)
    b = torch.stack([y for _, y in pairs], dim=1)
    return limbs.mont_mul_w(FQ, a, b).unbind(1)


def _add(*pairs):
    a = torch.stack([x for x, _ in pairs], dim=1)
    b = torch.stack([y for _, y in pairs], dim=1)
    return limbs.add_w(FQ, a, b).unbind(1)


def _sub(*pairs):
    a = torch.stack([x for x, _ in pairs], dim=1)
    b = torch.stack([y for _, y in pairs], dim=1)
    return limbs.sub_w(FQ, a, b).unbind(1)


def _complete_add_w(X1, Y1, Z1, X2, Y2, Z2):
    """RCB15 algorithm 7 (a = 0, b3 = 9), the schedule of
    `ezkl_tpu.fieldmath.curve.add`, with its independent operations
    grouped: every value is computed by the same field operation on the
    same operands, so the results are identical."""
    s1, s2, s3, s4, s5, s6 = _add((X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2))
    t0, t1, t2, t3, t4, X3 = _mul((X1, X2), (Y1, Y2), (Z1, Z2), (s1, s2), (s3, s4), (s5, s6))
    u1, u2, u3, X3d = _add((t0, t1), (t1, t2), (t0, t2), (t0, t0))
    t3, t4, Y3 = _sub((t3, u1), (t4, u2), (X3, u3))
    t0, = _add((X3d, t0))                                   # 3 * t0
    t2, Y3 = _xb3(t2, Y3)
    Z3, = _add((t1, t2))
    t1, = _sub((t1, t2))
    X3, t2, Y3, t1, t0, Z3 = _mul((t4, Y3), (t3, t1), (Y3, t0), (t1, Z3), (t0, t3), (Z3, t4))
    X3, = _sub((t2, X3))
    Y3, Z3 = _add((t1, Y3), (Z3, t0))
    return X3, Y3, Z3


def _xb3(*vals):
    """v * 9 for each v by the doubling chain of `limbs.small_mul(fq, v, 9)`."""
    t = vals
    for _ in range(3):
        t = _add(*((x, x) for x in t))
    return _add(*zip(t, vals))


def _dbl_w(X, Y, Z):
    """RCB15 algorithm 9 (a = 0, b3 = 9), the schedule of
    `ezkl_tpu.fieldmath.curve.dbl`, independent operations grouped."""
    t0, t1, t2, XY = _mul((Y, Y), (Y, Z), (Z, Z), (X, Y))
    Z3 = t0
    for _ in range(3):
        Z3, = _add((Z3, Z3))                                # 8 * t0
    t2, = _xb3(t2)
    Y3, t1b = _add((t0, t2), (t2, t2))
    t2b, = _add((t1b, t2))                                  # 3 * t2
    t0, = _sub((t0, t2b))
    X3, Z3, Y3, X3b = _mul((t2, Z3), (t1, Z3), (t0, Y3), (t0, XY))
    Y3, X3 = _add((X3, Y3), (X3b, X3b))
    return X3, Y3, Z3


def _flat(t):
    return limbs._w(t.reshape(NWORDS, -1))


@torch.inference_mode()
def point_add_plain(p: PointP, q: PointP) -> PointP:
    """Plain PyTorch version of K3 (either device)."""
    bs = p.x.shape
    assert bs == q.x.shape, f"batch mismatch {bs} vs {q.x.shape}"
    out = _complete_add_w(*(_flat(c) for c in (*p, *q)))
    return PointP(*(limbs._i32(c).reshape(bs) for c in out))


@torch.inference_mode()
def point_dbl_plain(p: PointP) -> PointP:
    """Plain PyTorch version of K9 (either device)."""
    bs = p.x.shape
    out = _dbl_w(*(_flat(c) for c in p))
    return PointP(*(limbs._i32(c).reshape(bs) for c in out))


def _launch(name: str, fn: str, coords):
    lib = build.lib()
    bs = coords[0].shape
    ins = [c.reshape(NWORDS, -1).contiguous() for c in coords]
    build.require_card(name, *ins)
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    n = ins[0].shape[1]
    if n:
        rc = getattr(lib, fn)(*(t.data_ptr() for t in ins + outs), n, build.stream_of(ins[0]))
        build.check(rc, name)
        build.LAUNCHES[name] += 1
    return PointP(*(o.reshape(bs) for o in outs))


def point_add(p: PointP, q: PointP) -> PointP:
    """Complete projective add, batch shapes equal (K3)."""
    assert p.x.shape == q.x.shape, f"batch mismatch {p.x.shape} vs {q.x.shape}"
    if p.x.is_cuda:
        return _launch("point_add", "ez_point_add", (*p, *q))
    return point_add_plain(p, q)


def point_dbl(p: PointP) -> PointP:
    """Projective doubling (K9)."""
    if p.x.is_cuda:
        return _launch("point_dbl", "ez_point_dbl", tuple(p))
    return point_dbl_plain(p)


"""Point kernels over BN254 G1: K3 (complete add) and K9 (doubling), and the
fused MSM's step-loop kernels K4-K8.

K3 and K9 replace the TPU kernels `_add_call` and `_dbl_call` of
`ezkl_tpu/kernels/pcurve.py` (entries `add` :722 and `dbl` :741); their CUDA
kernels are in `csrc/curve.cu`, with K3 also in a tree form: the halving
tree of `reduce_pairwise` in one launch. Both pick a team of threads per
lane by width (`point_add_team`, `dbl_team`). K4 `prefix_scan_packed`, K5
`prefix_scan_steps`, K6 `fold_lanes`, K7 `dbl_pow2` and K8 `horner_combine`
replace `_scan_call_packed`, `_scan_call`, `_fold_call`, `_dbln_call` and
`_horner_call` (entries :389, :414, :499, :694, :628); their CUDA kernels are
in `csrc/msm.cu`, which says what bounds each on the H100 and what its design
does about it. The CUDA kernels run RCB15 algorithms 7, 8 and 9 in the lazy
< 2p domain and store canonical coordinates; the plain versions here run the
strict schedules of `ezkl_tpu.fieldmath.curve.add/add_mixed/dbl` on int64
words, one vectorised point operation over all lanes per step. Both yield the
same canonical projective triples.

Every entry dispatches on the device of its tensors: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain version.
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


def _mixed_add_w(X1, Y1, Z1, X2, Y2):
    """RCB15 algorithm 8 (a = 0, b3 = 9): projective (X1:Y1:Z1), identity
    allowed, plus the affine (X2, Y2), not the identity. The schedule of
    `ezkl_tpu.fieldmath.curve.add_mixed`, independent operations grouped."""
    s1, s2 = _add((X2, Y2), (X1, Y1))
    t0, t1, t3, t4, Y3 = _mul((X1, X2), (Y1, Y2), (s1, s2), (Y2, Z1), (X2, Z1))
    u, t4, Y3, X3d = _add((t0, t1), (t4, Y1), (Y3, X1), (t0, t0))
    t3, = _sub((t3, u))
    t0, = _add((X3d, t0))                                   # 3 * t0
    t2, Y3 = _xb3(Z1, Y3)
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


def _launch(name: str, fn: str, coords, post=()):
    """K3 or K9 on coordinates of any (equal) batch shape, flattened."""
    bs = coords[0].shape
    flat = tuple(c.reshape(NWORDS, -1).contiguous() for c in coords)
    n = flat[0].shape[1]
    return _kernel(name, fn, flat, (n,), post=(n, *post)).map(lambda o: o.reshape(bs))


# K3's single add runs a team of 8 threads per lane where few lanes leave the
# card idle and of 2 where many fill it (`csrc/curve.cu`). The limit is from
# the H100 sweep at the widths the k = 14 prove launches it, 26 to 106,496
# lanes, in `chip_smoke.py`: 8 wins up to 3,328 lanes, 2 from 13,312 up, and
# one thread per lane at none (PERF.md, K3's row).
ADD_TEAMS = (2, 8)
ADD_TEAM8_LANES = 4096


def point_add_team(n: int) -> int:
    """Threads per lane of K3's single add for n lanes."""
    return 8 if n <= ADD_TEAM8_LANES else 2


def _add_launch(coords, team: int) -> PointP:
    n = coords[0].reshape(NWORDS, -1).shape[1]
    out = _launch("point_add", "ez_point_add", coords, post=(team,))
    if n:
        build.WIDTHS.append(("point_add", FQ.name, n, 12 * n))
    return out


def point_add(p: PointP, q: PointP) -> PointP:
    """Complete projective add, batch shapes equal (K3)."""
    assert p.x.shape == q.x.shape, f"batch mismatch {p.x.shape} vs {q.x.shape}"
    if p.x.is_cuda:
        return _add_launch((*p, *q), point_add_team(p.x[0].numel()))
    return point_add_plain(p, q)


# K9 runs a team of T threads per lane (`csrc/curve.cu`): 4 where few lanes
# leave the card idle and one doubling's latency sets the time, 2 above. Its
# launches: 2^k lanes in `gen_srs` (2^14 at k = 14), 26 and 1 lanes in the
# unfused MSM. The limit is from the H100 sweep in `chip_smoke.py`: 4 won up
# to 2^13 lanes, 2 at 2^14 (PERF.md, K9's row).
DBL_TEAMS = (2, 4)
DBL_TEAM4_LANES = 1 << 13


def dbl_team(n: int) -> int:
    """Threads per lane of K9 for n lanes."""
    return 4 if n <= DBL_TEAM4_LANES else 2


def _dbl_launch(coords, team: int) -> PointP:
    n = coords[0].reshape(NWORDS, -1).shape[1]
    out = _launch("point_dbl", "ez_point_dbl", coords, post=(team,))
    if n:
        build.WIDTHS.append(("point_dbl", FQ.name, n, 8 * n))
    return out


def point_dbl(p: PointP) -> PointP:
    """Projective doubling (K9)."""
    if p.x.is_cuda:
        return _dbl_launch(tuple(p), dbl_team(p.x[0].numel()))
    return point_dbl_plain(p)


# ---------------------------------------------------------------------------
# K4-K8: the fused MSM's step loops. The kernels read step-major layouts
# (8, S, m) for the scans, so that the lanes of one step are contiguous; the
# reference-layout entries (steps on the last axis) transpose around them.
# ---------------------------------------------------------------------------

def _one_w(batch, device):
    return limbs._w(limbs.ones_mont(FQ, batch, device))


def _chain_plain(coords, step_dim: int, mixed: bool, every: bool, skip=None):
    """The step loop of K4-K6 on the plain ops: coords (x, y[, z]) int64
    words, steps along `step_dim` of the batch; step 0 loads (z = 1 when
    mixed), each later step adds the next point. Where the bool `skip`
    (batch-shaped) is set, the point is the identity: z = 0 at step 0, no
    add later. Returns every step's prefix (stacked along `step_dim`) or
    only the last."""
    steps = coords[0].shape[1 + step_dim]
    take = lambda a, s: a.select(1 + step_dim, s)              # noqa: E731
    acc, outs = None, []
    for s in range(steps):
        X2, Y2 = take(coords[0], s), take(coords[1], s)
        if acc is None:
            Z2 = _one_w(X2.shape[1:], X2.device) if mixed else take(coords[2], s)
            acc = (X2, Y2, Z2 if skip is None else torch.where(take(skip[None], s), 0, Z2))
        else:
            new = (_mixed_add_w(*acc, X2, Y2) if mixed
                   else _complete_add_w(*acc, X2, Y2, take(coords[2], s)))
            acc = new if skip is None else tuple(
                torch.where(take(skip[None], s), a, b) for a, b in zip(acc, new))
        if every:
            outs.append(acc)
    if every:
        return PointP(*(limbs._i32(torch.stack([o[i] for o in outs], dim=1 + step_dim))
                        for i in range(3)))
    return PointP(*(limbs._i32(a) for a in acc))


def _kernel(name, fn, coords, out_batch, pre=(), post=(), sign=None):
    """Launch `fn(*pre, *inputs, ox, oy, oz, *post, stream)` of the kernel
    library on the limb tensors `coords` and count the launch. The inputs
    are their pointers, then K4's sign plane `sign`, or NULL for the z of a
    mixed (x, y) variant."""
    lib = build.lib()
    build.require_card(name, *coords, ndim=coords[0].dim())
    dev = coords[0].device
    if sign is not None and (not sign.is_cuda or sign.device != dev or sign.dtype != torch.int32
                             or not sign.is_contiguous() or sign.shape != coords[0].shape[1:]):
        raise ValueError(f"{name}: the sign plane must be a contiguous int32 (S, m) on the card")
    outs = [torch.empty((NWORDS,) + tuple(out_batch), dtype=torch.int32, device=dev)
            for _ in range(3)]
    if outs[0].numel():
        ins = [c.data_ptr() for c in coords]
        if sign is not None:
            ins.append(sign.data_ptr())
        elif len(coords) == 2:
            ins.append(None)
        rc = getattr(lib, fn)(*pre, *ins, *(o.data_ptr() for o in outs), *post,
                              build.stream_of(coords[0]))
        build.check(rc, name)
        build.LAUNCHES[name] += 1
    return PointP(*outs)


def _coords(p):
    """PointP (complete) or (x, y) tuple (mixed) -> (coords, mixed)."""
    mixed = not isinstance(p, PointP)
    return (tuple(p) if mixed else (p.x, p.y, p.z)), mixed


# K4 ----------------------------------------------------------------------

@torch.inference_mode()
def scan_packed_plain(px, py, sn) -> PointP:
    """Plain PyTorch version of K4 on the step-major layout: px, py (8, S, m),
    sn (S, m) with nonzero = negate y. The pair (0, 1) is the identity."""
    one = limbs.ones_mont(FQ, px.shape[1:], px.device)
    pad = ((px == 0) & (py == one)).all(dim=0)
    y = limbs.select(sn != 0, limbs.neg(FQ, py), py)
    return _chain_plain((limbs._w(px), limbs._w(y)), 0, mixed=True, every=True, skip=pad)


# K4, K5 and K6 run a team of 8 or 2 threads per lane (`csrc/msm.cu`). The
# larger team shortens a lane's chain but repeats the adds between the
# products in every thread: it pays where few lanes leave the card idle, the
# smaller one where many lanes fill it. The limit is from the H100 sweeps of
# each of the three kernels at 832-1,001 and 3,328 to 26,624 lanes in
# `chip_smoke.py`: each crosses between 3,328 and 6,656 lanes (PERF.md, K4's,
# K5's and K6's rows); teams of 4 were never the fastest for K4.
SCAN_TEAMS = (2, 8)
SCAN_TEAM8_LANES = 4096


def lane_team(m: int) -> int:
    """Threads per lane of K4, K5 or K6 for m lanes."""
    return 8 if m <= SCAN_TEAM8_LANES else 2


def _scan_packed_launch(px, py, sn, team: int) -> PointP:
    S, m = px.shape[1:]
    out = _kernel("scan_packed", "ez_scan_packed", (px, py), (S, m), post=(m, S, team),
                  sign=sn)
    if m * S:
        build.WIDTHS.append(("scan_packed", FQ.name, m, 11 * (S - 1) * m,
                             (2 * 32 + 4 + 3 * 32) * S * m))
    return out


def _scan_packed_kernel(px, py, sn) -> PointP:
    return _scan_packed_launch(px, py, sn, lane_team(px.shape[2]))


def scan_packed_steps(px, py, sn) -> PointP:
    """K4 on the step-major layout: px, py (8, S, m) affine coordinates (z = 1),
    sn (S, m) int32 with nonzero = negate y. Returns the projective prefix
    along S, (8, S, m), canonical. The pair (0, 1), on no curve
    y^2 = x^3 + 3, stands for the identity: it is the affine image of the
    identity lanes of `msm.pad_msm_inputs`. (The TPU kernel adds it as a
    point, which makes the fused MSM of padded inputs wrong; on any other
    input the two agree bit for bit.)"""
    if px.is_cuda:
        return _scan_packed_kernel(px.contiguous(), py.contiguous(),
                                   sn.to(torch.int32).contiguous())
    return scan_packed_plain(px, py, sn)


def prefix_scan_packed(px, py, sn) -> PointP:
    """Inclusive point prefix along the last axis (K4), the reference's
    entry: px, py (8, m, S) packed coordinates (the port's words are the
    reference's 2x16-bit packing), sn (m, S) with 1 = negate y. Returns
    PointP (8, m, S)."""
    t = lambda a: a.movedim(-1, -2).contiguous()                   # noqa: E731
    out = scan_packed_steps(t(px), t(py), t(sn))
    return out.map(lambda a: a.movedim(-2, -1))


# K5 ----------------------------------------------------------------------

@torch.inference_mode()
def scan_steps_plain(p) -> PointP:
    """Plain PyTorch version of K5 on the step-major layout (8, S, m)."""
    coords, mixed = _coords(p)
    return _chain_plain(tuple(limbs._w(c) for c in coords), 0, mixed, every=True)


def _scan_steps_launch(p, team: int) -> PointP:
    coords, mixed = _coords(p)
    S, m = coords[0].shape[1:]
    out = _kernel("scan_steps", "ez_scan_steps", coords, (S, m), pre=(int(mixed),),
                  post=(m, S, team))
    if m * S:
        build.WIDTHS.append(("scan_steps", FQ.name, m, (11 if mixed else 12) * (S - 1) * m,
                             (len(coords) + 3) * 32 * S * m))
    return out


def _scan_steps_kernel(p) -> PointP:
    return _scan_steps_launch(p, lane_team(_coords(p)[0][0].shape[2]))


def scan_steps(p) -> PointP:
    """K5 on the step-major layout: p a projective PointP ((0:1:0)
    identities allowed; complete adds) or an affine (x, y) tuple (z = 1,
    identity-free; mixed adds), coordinates (8, S, m). Returns the
    projective prefix along S, (8, S, m), canonical."""
    coords, mixed = _coords(p)
    if coords[0].is_cuda:
        coords = tuple(c.contiguous() for c in coords)
        return _scan_steps_kernel(coords if mixed else PointP(*coords))
    return scan_steps_plain(p)


def prefix_scan_steps(p) -> PointP:
    """Inclusive point prefix along the LAST axis of an (8, m, S) batch
    (K5), the reference's entry. p: PointP or (x, y) tuple, as `scan_steps`.
    Returns PointP (8, m, S)."""
    coords, mixed = _coords(p)
    t = tuple(c.movedim(-1, -2).contiguous() for c in coords)
    out = scan_steps(t if mixed else PointP(*t))
    return out.map(lambda a: a.movedim(-2, -1))


# K6 ----------------------------------------------------------------------

@torch.inference_mode()
def fold_lanes_plain(p, blk: int) -> PointP:
    """Plain PyTorch version of K6: coordinates (8, G, chunks * blk) ->
    (8, G, blk)."""
    coords, mixed = _coords(p)
    G, n = coords[0].shape[1:]
    ws = tuple(limbs._w(c).reshape(NWORDS, G, n // blk, blk) for c in coords)
    return _chain_plain(ws, 1, mixed, every=False)


def _fold_lanes_launch(p, blk: int, team: int) -> PointP:
    coords, mixed = _coords(p)
    G, n = coords[0].shape[1:]
    chunks, lanes = n // blk, G * blk
    out = _kernel("fold_lanes", "ez_fold_lanes", coords, (G, blk), pre=(int(mixed),),
                  post=(G, chunks, blk, team))
    if lanes:
        build.WIDTHS.append(("fold_lanes", FQ.name, lanes, (11 if mixed else 12) * (chunks - 1)
                             * lanes, (len(coords) * chunks + 3) * 32 * lanes))
    return out


def _fold_lanes_kernel(p, blk: int) -> PointP:
    G = _coords(p)[0][0].shape[1]
    return _fold_lanes_launch(p, blk, lane_team(G * blk))


def fold_lanes(p, blk: int = 1024) -> PointP:
    """Sum points along the last axis down to `blk` lane partials (K6): lane
    l of group g holds sum_j p[g, j * blk + l], accumulated in chunk order.
    p: projective PointP ((0:1:0) identities allowed) or affine (x, y)
    tuple (identity-free), shaped (8, n) or (8, G, n); n a multiple of blk,
    which drops to 128 for n < blk. Finish with `reduce_pairwise`. Returns
    (8, blk) or (8, G, blk)."""
    coords, mixed = _coords(p)
    n = coords[0].shape[-1]
    grouped = coords[0].dim() == 3
    if n < blk:
        blk = 128
    assert n % blk == 0, f"fold_lanes: n={n} not a multiple of blk={blk}"
    coords = tuple(c.reshape(NWORDS, -1, n) for c in coords)
    on_card = coords[0].is_cuda
    if on_card:
        coords = tuple(c.contiguous() for c in coords)
    q = coords if mixed else PointP(*coords)
    out = _fold_lanes_kernel(q, blk) if on_card else fold_lanes_plain(q, blk)
    return out if grouped else out.map(lambda a: a[:, 0])


@torch.inference_mode()
def reduce_pairwise_plain(p: PointP) -> PointP:
    """Plain PyTorch version of K3's tree form: the halving loop of
    `point_add_plain`."""
    w = p.x.shape[-1]
    while w > 1:
        half = w // 2
        p = point_add_plain(p.map(lambda t: t[..., :half]), p.map(lambda t: t[..., half:w]))
        w = half
    return p.map(lambda t: t[..., 0])


# partials per group that `ez_point_reduce` holds in shared memory
TREE_MAX = 256


def _reduce_kernel(p: PointP) -> PointP:
    """K3's tree form on (8, ..., w), 2 <= w <= TREE_MAX."""
    bs, w = p.x.shape[1:-1], p.x.shape[-1]
    flat = tuple(c.reshape(NWORDS, -1, w).contiguous() for c in p)
    groups = flat[0].shape[1]
    out = _kernel("point_reduce", "ez_point_reduce", flat, (groups,), post=(groups, w))
    if groups:
        build.WIDTHS.append(("point_reduce", FQ.name, groups * w, 12 * groups * (w - 1)))
    return out.map(lambda o: o.reshape((NWORDS,) + tuple(bs)))


def reduce_pairwise(p: PointP) -> PointP:
    """(8, ..., w) partials -> (8, ...) total by log2(w) halving complete
    adds, lane j plus lane j + w/2 (K3; identity lanes allowed). On the card
    the tree is one launch (`ez_point_reduce`), after one K3 launch per
    level above TREE_MAX partials."""
    if not p.x.is_cuda:
        return reduce_pairwise_plain(p)
    w = p.x.shape[-1]
    assert w & (w - 1) == 0, f"reduce_pairwise: w={w} is no power of two"
    while w > TREE_MAX:
        half = w // 2
        p = point_add(p.map(lambda t: t[..., :half]), p.map(lambda t: t[..., half:]))
        w = half
    if w == 1:
        return p.map(lambda t: t[..., 0])
    return _reduce_kernel(p)


def fold_all(p, blk: int = 1024) -> PointP:
    """Full sum along the last axis: `fold_lanes` + the halving tree -> (8,).
    p: projective PointP (identity lanes allowed) or affine (x, y) tuple
    (identity-free); an affine input whose length is no block multiple is
    promoted to projective and padded with identities."""
    from ..fieldmath import curve
    coords, mixed = _coords(p)
    n = coords[0].shape[-1]
    use_blk = blk if n >= blk else 128
    if n % use_blk:
        if mixed:
            p = curve.from_affine(*coords)
        idp = curve.identity((-(-n // use_blk) * use_blk - n,), coords[0].device)
        p = PointP(*(torch.cat([a, b], dim=-1) for a, b in zip(p, idp)))
    return reduce_pairwise(fold_lanes(p, blk=blk))


# K7 ----------------------------------------------------------------------

@torch.inference_mode()
def dbl_pow2_plain(p: PointP, c: int) -> PointP:
    """Plain PyTorch version of K7 on (8, n)."""
    acc = tuple(limbs._w(t) for t in p)
    for _ in range(c):
        acc = _dbl_w(*acc)
    return PointP(*(limbs._i32(a) for a in acc))


def _dbl_pow2_kernel(p: PointP, c: int) -> PointP:
    n = p.x.shape[1]
    out = _kernel("dbl_pow2", "ez_dbl_pow2", tuple(p), (n,), post=(n, c))
    if n:
        build.WIDTHS.append(("dbl_pow2", FQ.name, n, 8 * c * n, 6 * 32 * n))
    return out


def dbl_pow2(p: PointP, c: int) -> PointP:
    """2^c * P by c doublings (K7), any batch shape; c >= 1."""
    assert c >= 1, "dbl_pow2: c >= 1"
    bs = p.x.shape
    flat = p.map(lambda a: a.reshape(NWORDS, -1).contiguous())
    out = _dbl_pow2_kernel(flat, c) if p.x.is_cuda else dbl_pow2_plain(flat, c)
    return out.map(lambda a: a.reshape(bs))


# K8 ----------------------------------------------------------------------

@torch.inference_mode()
def horner_plain(v: PointP, c: int) -> PointP:
    """Plain PyTorch version of K8: v (8, W, width) -> (8, width)."""
    W, width = v.x.shape[1:]
    one = _one_w((width,), v.x.device)
    zero = torch.zeros_like(one)
    acc = (zero, one, zero)
    vw = tuple(limbs._w(t) for t in v)
    for w in range(W):
        for _ in range(c):
            acc = _dbl_w(*acc)
        acc = _complete_add_w(*acc, *(t[:, w] for t in vw))
    return PointP(*(limbs._i32(a) for a in acc))


def _horner_kernel(v: PointP, c: int) -> PointP:
    W, width = v.x.shape[1:]
    out = _kernel("horner", "ez_horner", tuple(v), (width,), post=(W, c, width))
    if width:
        build.WIDTHS.append(("horner", FQ.name, width, W * (8 * c + 12) * width,
                             3 * 32 * (W + 1) * width))
    return out


def horner_combine(v: PointP, c: int) -> PointP:
    """MSB-first Horner over windows (K8): sum_w 2^(c * (W-1-w)) * V_w, i.e.
    acc = 2^c * acc + V_w from the identity. v: PointP (8, W, width) with
    the MSB window FIRST along the window axis. Returns (8, width)."""
    if v.x.is_cuda:
        return _horner_kernel(v.map(torch.Tensor.contiguous), c)
    return horner_plain(v, c)

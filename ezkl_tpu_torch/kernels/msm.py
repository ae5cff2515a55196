"""Pippenger multi-scalar multiplication over BN254 G1 (port of
`ezkl_tpu/kernels/msm.py`).

Two pipelines compute the same sums; both run on either device:

* `msm_multi` / `msm` -- the fused MSM, `_msm_multi_fused` of the JAX package
  (`msm.py:504-625`), what the TPU runs. Every sequential chain is one
  kernel launch: the S-step local prefix scan over the gathered points (K4
  on packed affine points with a sign plane when `affine=True`, else K5 by
  complete adds), the log recursion over the block totals (K5, combined by
  K3), the per-window bucket fold (K6, finished by K3 halving adds), the
  2^(c-1) doublings of the window totals (K7) and the Horner combine of the
  windows (K8).
* `msm_multi_unfused` -- the JAX package's non-TPU configuration
  (`msm.py:326-437`): a blocked prefix scan, fold and Horner combine in
  which every group operation is one elementwise point add (K3) or
  doubling (K9).

Both use signed window digits, a stable sort of the digits, a gather of the
points into digit order, and bucket sums read at the bucket boundaries
(telescoped: sum_b b*S_b = B*T - sum_b E[s_b]). The fused pipeline walks
the windows in groups, as the reference does: a group bounds the memory of
the sort, gather and scan (`window_group`), and a group only changes the
batching, not the result.

The result is a projective point; the two pipelines agree as affine points,
and the fused one equals the JAX package's fused MSM bit for bit. Commitments
decode to affine, so the proof bytes do not depend on which MSM ran.
"""

from __future__ import annotations

import functools

import torch

from ..fieldmath import curve, limbs
from ..fieldmath.curve import PointP
from ..fieldmath.spec import bn254_fr, NWORDS
from . import pcurve

_BLOCK = 32      # sequential steps per scan level of the unfused pipeline
_FUSED_S = 128   # local-scan steps per lane of the fused pipeline
# point-windows (windows x points) of one group of the fused MSM: a group
# gathers, sorts and scans its windows' points together, and at 2^23 its
# working set stays under ~2 GiB on the card (the gathered x, y: 512 MiB;
# K4's projective prefix: 768 MiB; the int64 digits, sort keys and indices:
# ~320 MiB). Every commitment of a k <= 14 prove fits one group.
GROUP_POINTS = 1 << 23


def default_window_bits(n: int) -> int:
    """Signed-digit window size minimizing n_windows * (linear work + bucket
    work), with the per-point and per-bucket costs the JAX package fitted
    (`msm.py:89-106`); kept so that c matches the reference."""
    best_c, best_t = 2, float("inf")
    for c in range(2, 21):
        t = len(_signed_windows(c)) * (n * 60e-9 + (1 << (c - 1)) * 190e-9)
        if t < best_t:
            best_c, best_t = c, t
    return best_c


def extract_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(8, *batch) raw (non-Montgomery) scalar limbs -> (W, *batch) int64
    window digits; window w holds bits [w*c, (w+1)*c)."""
    W = -(-256 // c)
    w = limbs._w(scalars)
    w = torch.cat([w, torch.zeros_like(w[:1])], dim=0)
    starts = torch.arange(W, device=w.device) * c
    idx, r = starts // 32, (starts % 32).reshape((W,) + (1,) * (w.dim() - 1))
    d = (w[idx] >> r) | ((w[idx + 1] & 0xFFFFF) << (32 - r))   # c <= 20
    return d & ((1 << c) - 1)


@functools.lru_cache(maxsize=32)
def _signed_windows(c: int) -> range:
    """Number of c-bit SIGNED windows covering any reduced Fr scalar (the
    recoding carry out of the top window must vanish)."""
    p = bn254_fr().modulus
    W = -(-254 // c)
    while ((p - 1) >> ((W - 1) * c)) + 1 > (1 << (c - 1)):
        W += 1
    return range(W)


def extract_digits_signed(scalars: torch.Tensor, c: int):
    """(8, *batch) raw Fr limbs -> (mags, negs), each (W, *batch):
    scalar = sum_w (-1)^negs[w] * mags[w] * 2^(c*w), mags in [0, 2^(c-1)]."""
    raw = extract_digits(scalars, c)
    half, full = 1 << (c - 1), 1 << c
    mags, negs = [], []
    carry = torch.zeros_like(raw[0])
    for w in _signed_windows(c):
        d = (raw[w] if w < raw.shape[0] else torch.zeros_like(carry)) + carry
        ng = d > half
        mags.append(torch.where(ng, full - d, d))
        negs.append(ng)
        carry = ng.long()
    return torch.stack(mags), torch.stack(negs)


def _stack_points(pts, dim=-1) -> PointP:
    return PointP(*(torch.stack([p[i] for p in pts], dim=dim) for i in range(3)))


def _seq_inclusive(p: PointP) -> PointP:
    """Inclusive prefix along the last axis, one point add per step."""
    xs = p.map(lambda a: a.movedim(-1, 1).contiguous())
    acc = curve.identity(p.batch_shape[:-1], p.device)
    outs = []
    for s in range(p.x.shape[-1]):
        acc = curve.add(acc, xs.map(lambda a: a[:, s]))
        outs.append(acc)
    return _stack_points(outs)


def prefix_scan_points(p: PointP) -> PointP:
    """Inclusive prefix sum of points along the last batch axis: (m, BLOCK)
    local scans, a recursive scan of the block totals, one combine add."""
    n = p.x.shape[-1]
    if n <= _BLOCK:
        return _seq_inclusive(p)
    assert n % _BLOCK == 0, "prefix_scan_points: need n % BLOCK == 0"
    m = n // _BLOCK
    local = _seq_inclusive(p.map(lambda a: a.reshape(a.shape[:-1] + (m, _BLOCK))))
    tot_pref = prefix_scan_points(local.map(lambda a: a[..., -1]))
    offs = tot_pref.map(lambda a: torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], -1))
    first = (torch.arange(m, device=p.device) == 0).expand(offs.batch_shape)
    offs = curve.select_point(first, curve.identity(offs.batch_shape, p.device), offs)
    combined = curve.add(local, offs.map(lambda a: a[..., None].expand(local.x.shape)))
    return combined.map(lambda a: a.reshape(a.shape[:-2] + (n,)))


def fold_points(p: PointP) -> PointP:
    """Sum of points along the last axis (any length): blocked accumulation
    of width n/BLOCK, then one short sequential fold."""
    n = p.x.shape[-1]
    while n > _BLOCK:
        m = -(-n // _BLOCK)
        if m * _BLOCK != n:
            idp = curve.identity(p.batch_shape[:-1] + (m * _BLOCK - n,), p.device)
            p = PointP(*(torch.cat([a, b], dim=-1) for a, b in zip(p, idp)))
        xs = p.map(lambda a: a.reshape(a.shape[:-1] + (m, _BLOCK)).movedim(-1, 1).contiguous())
        acc = curve.identity(xs.x.shape[2:], p.device)
        for s in range(_BLOCK):
            acc = curve.add(acc, xs.map(lambda a: a[:, s]))
        p, n = acc, m
    xs = p.map(lambda a: a.movedim(-1, 1).contiguous())
    acc = curve.identity(p.batch_shape[:-1], p.device)
    for s in range(n):
        acc = curve.add(acc, xs.map(lambda a: a[:, s]))
    return acc


def dbl_n(p: PointP, k: int) -> PointP:
    for _ in range(k):
        p = curve.dbl(p)
    return p


def _gather_last(p: PointP, idx: torch.Tensor) -> PointP:
    """Coordinates (8, G, L) read at idx (G, Q) along the last axis."""
    e = idx[None].expand((NWORDS,) + tuple(idx.shape))
    return p.map(lambda a: torch.gather(a, -1, e))


def msm(points: PointP, scalars: torch.Tensor, c: int | None = None,
        affine: bool = False, group: int | None = None) -> PointP:
    """sum_i scalars[i] * points[i] by the fused MSM; points batch (N,), N a
    power of two (identity lanes (0:1:0) allowed; `affine=True` asserts
    z == 1 on every other lane), scalars (8, N) RAW Fr limbs. Returns a
    projective PointP of batch ()."""
    return msm_multi(points, scalars[None], c=c, affine=affine,
                     group=group).map(lambda a: a[..., 0])


def _prefix_points_fused(p: PointP) -> PointP:
    """Inclusive prefix of projective points along the LAST axis (any
    leading batch axes): S-step scans (K5), a log recursion over the block
    totals, and one combine add (K3) of the previous blocks' prefix, the
    identity for the first block."""
    m = p.x.shape[-1]
    S = 32 if m <= 1024 else _FUSED_S
    lead = p.x.shape[1:-1]
    if m <= S:
        out = pcurve.prefix_scan_steps(p.map(lambda a: a.reshape(NWORDS, -1, m)))
        return out.map(lambda a: a.reshape(p.x.shape))
    assert m % S == 0, f"prefix_points_fused: {m} % {S}"
    local = pcurve.prefix_scan_steps(p.map(lambda a: a.reshape(NWORDS, -1, S)))
    tp = _prefix_points_fused(local.map(lambda a: a[..., -1].reshape((NWORDS,) + lead + (m // S,))))
    offs = tp.map(lambda a: torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], -1))
    first = (torch.arange(m // S, device=p.device) == 0).expand(offs.batch_shape)
    offs = curve.select_point(first, curve.identity(offs.batch_shape, p.device), offs)
    comb = curve.add(local, offs.map(lambda a: a.reshape(NWORDS, -1, 1).expand(local.x.shape)))
    return comb.map(lambda a: a.reshape(p.x.shape))


def window_group(C: int, W: int, n: int) -> int:
    """Windows per group of `msm_multi` for C columns of W windows over n
    points: every window at once while C * W * n <= GROUP_POINTS, else as
    many whole columns as fit, else the largest divisor of W that fits (a
    column's windows split, as the JAX package's `_fused_group` splits
    them; `msm.py:460-467`)."""
    if C * W * n <= GROUP_POINTS:
        return C * W
    if W * n <= GROUP_POINTS:
        return W * (GROUP_POINTS // (W * n))
    g = max(1, GROUP_POINTS // n)
    while W % g:
        g -= 1
    return g


def _group_sums(points: PointP, d: torch.Tensor, ng: torch.Tensor, c: int, affine: bool):
    """One group of windows, digits d (G, N) and signs ng (G, N): the
    window totals T_w (8, G) and the fold partials of sum_b E[s_b]
    (8, G, fold_blk), which `reduce_pairwise` finishes."""
    G, n = d.shape
    dev = points.device
    n_bound = 1 << (c - 1)
    S = min(_FUSED_S, n)
    lanes = G * (n // S)                 # scan lane (g, i): window g, points [i*S, (i+1)*S)

    sorted_d, order = torch.sort(d, dim=-1, stable=True)
    sn = torch.gather(ng, -1, order)
    # gather straight into the step-major layout (8, S, lanes) of the scan
    idx = order.reshape(G, n // S, S).permute(2, 0, 1).reshape(S, lanes)
    sn_t = sn.reshape(G, n // S, S).permute(2, 0, 1).reshape(S, lanes)
    del order, sn
    if affine:
        local = pcurve.scan_packed_steps(points.x[:, idx], points.y[:, idx],
                                         sn_t.to(torch.int32))
    else:
        sp = points.map(lambda a: a[:, idx])
        sp = PointP(sp.x, limbs.select(sn_t, curve.neg(sp).y, sp.y), sp.z)
        local = pcurve.scan_steps(sp)
    del idx, sn_t
    tot_incl = _prefix_points_fused(local.map(lambda a: a[:, S - 1].reshape(NWORDS, G, n // S)))
    t_w = tot_incl.map(lambda a: a[..., -1])                    # (8, G)

    queries = torch.arange(1, n_bound + 1, device=dev).expand(G, n_bound).contiguous()
    starts = torch.searchsorted(sorted_d, queries)              # (G, B)
    safe = starts.clamp(min=1) - 1
    # prefix at sorted position `safe` of window g: step safe % S of lane
    # g * (n/S) + safe // S
    g_lane = torch.arange(G, device=dev)[:, None] * (n // S)
    at = (safe % S) * lanes + g_lane + safe // S
    e_loc = local.map(lambda a: a.reshape(NWORDS, -1)[:, at])   # (8, G, B)
    del local
    blk = safe // S
    e_off = _gather_last(tot_incl, blk.clamp(min=1) - 1)
    e_off = curve.select_point(blk == 0, curve.identity(blk.shape, dev), e_off)
    e_pts = curve.add(e_loc, e_off)
    e_pts = curve.select_point(starts == 0, curve.identity(starts.shape, dev), e_pts)
    # pad the B bucket sums to a fold-block multiple with identities; fold
    fold_blk = 1024 if n_bound >= 2048 else 128
    pad_to = -(-n_bound // fold_blk) * fold_blk
    idp = curve.identity((G, pad_to - n_bound), dev)
    e_pts = PointP(*(torch.cat([a, b], dim=-1) for a, b in zip(e_pts, idp)))
    return t_w, pcurve.fold_lanes(e_pts, blk=fold_blk)


def msm_multi(points: PointP, scalars: torch.Tensor, c: int | None = None,
              affine: bool = False, group: int | None = None) -> PointP:
    """Batched-column MSM by the fused pipeline: out[t] = sum_i scalars[t, i]
    * points[i]. scalars: (C, 8, N) RAW limbs over a shared point set, N a
    power of two; returns PointP of batch (C,).

    The windows (g = column * W' + window) run in groups of `group` windows
    (default `window_group`), each group sorted, gathered, scanned and
    folded on its own; the window sums and the Horner combine then run once
    over all windows. A group of fewer windows than W splits each column,
    whose W windows are padded with zero windows to a multiple of `group`
    at the top (W' >= W), as in the JAX package (`msm.py:524-531`); a larger
    group holds group // W whole columns (W' = W), which the JAX package
    does not form. A window's sums do not depend on its group, so at one W'
    the words do not either.

    affine=True asserts z == 1 on every point but the identity lanes of
    `pad_msm_inputs` (SRS bases): the scan then gathers only (x, y) and runs
    mixed adds (K4), which reads an identity lane's pair (0, 1) as the
    identity (the JAX package adds it as a point, and its sum is wrong)."""
    C, _, n = scalars.shape
    assert (n & (n - 1)) == 0, "msm: pad N to a power of two"
    if c is None:
        c = default_window_bits(n)
    W = len(_signed_windows(c))
    G = group if group is not None else window_group(C, W, n)
    assert G >= 1, f"msm: group={G}"
    cols = max(1, G // W)                # columns whose digits are extracted together
    Wp = W if G >= W else -(-W // G) * G
    if G > W:
        G = cols * W
    t_ws, parts = [], []
    for c0 in range(0, C, cols):
        mags, negs = extract_digits_signed(scalars[c0:c0 + cols].movedim(0, 1), c)
        if Wp != W:                      # zero windows on top of each column
            pad = (Wp - W,) + tuple(mags.shape[1:])
            mags = torch.cat([mags, mags.new_zeros(pad)])
            negs = torch.cat([negs, negs.new_zeros(pad)])
        d = mags.movedim(1, 0).reshape(-1, n)                   # (cols * W', N)
        ng = negs.movedim(1, 0).reshape(-1, n)
        del mags, negs
        for g0 in range(0, d.shape[0], G):
            t_w, part = _group_sums(points, d[g0:g0 + G], ng[g0:g0 + G], c, affine)
            t_ws.append(t_w)
            parts.append(part)
    t_w = PointP(*(torch.cat([t[i] for t in t_ws], dim=1) for i in range(3)))
    part = PointP(*(torch.cat([p[i] for p in parts], dim=1) for i in range(3)))
    f_w = pcurve.reduce_pairwise(part)                          # (8, C * W')

    # V_w = B*T_w - F_w = sum_b b * bucket_b over this window's B = 2^(c-1)
    # buckets; Horner over the windows, MSB first
    u = pcurve.dbl_pow2(t_w, c - 1)
    v = curve.add(u, curve.neg(f_w)).map(lambda a: a.reshape(NWORDS, C, Wp))
    v_msb = v.map(lambda a: a.flip(-1).movedim(-1, 1).contiguous())    # (8, W', C)
    return pcurve.horner_combine(v_msb, c)


def msm_multi_unfused(points: PointP, scalars: torch.Tensor, c: int | None = None) -> PointP:
    """Batched-column MSM by the unfused pipeline (K3 and K9 per step):
    out[t] = sum_i scalars[t, i] * points[i]. scalars: (C, 8, N) RAW limbs
    over a shared point set; returns PointP of batch (C,)."""
    C, _, n = scalars.shape
    assert (n & (n - 1)) == 0, "msm: pad N to a power of two"
    dev = points.device
    if c is None:
        c = default_window_bits(n)
    digits, negs = extract_digits_signed(scalars.movedim(0, 1), c)   # (W, C, N)
    n_bound = 1 << (c - 1)
    W = digits.shape[0]
    G = C * W                                                   # window g = col*W + w
    d = digits.movedim(1, 0).reshape(G, n)
    ng = negs.movedim(1, 0).reshape(G, n)

    sorted_d, order = torch.sort(d, dim=-1, stable=True)
    pts = points.map(lambda a: a[:, order])                     # (8, G, N)
    sn = torch.gather(ng, -1, order)
    pts = PointP(pts.x, limbs.select(sn, curve.neg(pts).y, pts.y), pts.z)
    queries = torch.arange(1, n_bound + 1, device=dev).expand(G, n_bound).contiguous()
    starts = torch.searchsorted(sorted_d, queries)              # (G, B)
    safe = starts.clamp(min=1) - 1
    if n > _BLOCK:
        # prefix values are needed only at the bucket boundaries: block-local
        # prefixes plus the previous blocks' total, combined there only
        m = n // _BLOCK
        local = _seq_inclusive(pts.map(lambda a: a.reshape(NWORDS, G, m, _BLOCK)))
        tot_incl = prefix_scan_points(local.map(lambda a: a[..., -1]))   # (8, G, m)
        t_w = tot_incl.map(lambda a: a[..., -1])
        e_loc = _gather_last(local.map(lambda a: a.reshape(NWORDS, G, n)), safe)
        blk = safe // _BLOCK
        e_off = _gather_last(tot_incl, blk.clamp(min=1) - 1)
        e_off = curve.select_point(blk == 0, curve.identity(blk.shape, dev), e_off)
        e_pts = curve.add(e_loc, e_off)
    else:
        incl = prefix_scan_points(pts)
        t_w = incl.map(lambda a: a[..., -1])
        e_pts = _gather_last(incl, safe)
    e_pts = curve.select_point(starts == 0, curve.identity(starts.shape, dev), e_pts)
    f_w = fold_points(e_pts).map(lambda a: a.reshape(NWORDS, C, W))
    t_w = t_w.map(lambda a: a.reshape(NWORDS, C, W))

    # V_w = B*T_w - F_w = sum_b b * bucket_b over this window's B = 2^(c-1)
    # buckets
    v = curve.add(dbl_n(t_w, c - 1), curve.neg(f_w))            # (8, C, W)
    v = v.map(lambda a: a.movedim(-1, 1).contiguous())         # (8, W, C)
    acc = curve.identity((C,), dev)
    for w in range(W - 1, -1, -1):                              # Horner, MSB first
        acc = curve.add(dbl_n(acc, c), v.map(lambda a: a[:, w]))
    return acc


def pad_msm_inputs(points: PointP, scalars: torch.Tensor):
    """Pad N to the next power of two with identity points / zero scalars."""
    n = scalars.shape[-1]
    target = 1 if n == 0 else 1 << (n - 1).bit_length()
    if target == n:
        return points, scalars
    idp = curve.identity((target - n,), points.device)
    points = PointP(*(torch.cat([a, b], dim=-1) for a, b in zip(points, idp)))
    scalars = torch.cat([scalars, torch.zeros((NWORDS, target - n), dtype=scalars.dtype,
                                              device=scalars.device)], dim=-1)
    return points, scalars

"""Circuit op library: quantized forward + constraint layout per op.

Counterpart of the reference's PolyOp/LookupOp/HybridOp layout functions
(`ezkl/src/circuit/ops/{poly,lookup,hybrid}.rs` dispatching into
`layouts.rs` — SURVEY.md §2.2). Every op here computes its witness with
vectorized numpy int64 AND emits constraints through the span layout engine
in the same pass (the reference's combined witness_gen+layout mode,
`region.rs RegionSettings`).

Lookup table contents reproduce `tensor/ops.rs::nonlinearities` semantics:
dequantize -> f64 function -> round-half-even requantize.

Port of `ezkl_tpu/graph/ops.py` (pure numpy, copied; imports rewired to the
port's modules).
"""

from __future__ import annotations

import os

import numpy as np

from .layout import BaseConfig, LayoutCtx, Span, TVal
from .quantize import (quantize, dequantize, check_range, checked_mul,
                       checked_cumsum, checked_cumprod)


def _broadcast_indices(shape, out_shape) -> np.ndarray:
    """Flat source indices that broadcast `shape` to `out_shape` (row-major)."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)) or 1).reshape(shape)
    return np.ascontiguousarray(np.broadcast_to(idx, out_shape)).reshape(-1)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------

def pairwise(ctx: LayoutCtx, kind: str, a: TVal, b: TVal) -> TVal:
    """add | sub | mul with numpy broadcasting. Scales must already match
    for add/sub; mul adds scales (reference `poly.rs:367-426`)."""
    cfg = ctx.cfg
    out_shape = np.broadcast_shapes(a.shape, b.shape)
    L = int(np.prod(out_shape, dtype=np.int64)) or 1
    idx_a = _broadcast_indices(a.shape, out_shape)
    idx_b = _broadcast_indices(b.shape, out_shape)
    r = ctx.alloc(L)
    va = ctx.stage_operand(a, cfg.a0, r, idx_a)
    vb = ctx.stage_operand(b, cfg.a1, r, idx_b)
    if kind == "add":
        assert a.scale == b.scale, f"add scale mismatch {a.scale} vs {b.scale}"
        out, scale = va + vb, a.scale
    elif kind == "sub":
        assert a.scale == b.scale, f"sub scale mismatch {a.scale} vs {b.scale}"
        out, scale = va - vb, a.scale
    elif kind == "mul":
        out, scale = checked_mul(va, vb), a.scale + b.scale
    else:
        raise ValueError(kind)
    check_range(out)
    ctx.write(cfg.a2, r, out)
    ctx.enable(kind, r, L)
    return TVal(out.reshape(out_shape), scale, Span.contiguous(cfg.a2, r, L))


def const_mul(ctx: LayoutCtx, a: TVal, k: int, scale_delta: int = 0) -> TVal:
    """Multiply by integer constant k (e.g. 2^d for scale alignment)."""
    c = TVal(np.full(1, k, np.int64), scale_delta, None)
    return pairwise(ctx, "mul", a, c)


# ---------------------------------------------------------------------------
# accumulation (dot / sum) — rotation(-1) running gates
# ---------------------------------------------------------------------------

def _accumulate(ctx: LayoutCtx, kind: str, idx_a, idx_b, a: TVal,
                b: TVal | None, runs: int, run_len: int):
    """Generic contiguous-run accumulator layout. Returns (acc_values,
    out_rows) where out_rows are the run-final accumulator cells."""
    cfg = ctx.cfg
    L = runs * run_len
    r = ctx.alloc(L)
    va = ctx.stage_operand(a, cfg.a0, r, idx_a)
    if b is not None:
        vb = ctx.stage_operand(b, cfg.a1, r, idx_b)
        prod = checked_mul(va, vb)
    else:
        prod = va
    acc = checked_cumsum(prod.reshape(runs, run_len), axis=1).reshape(-1) \
        if kind == "dot" or kind == "sum" else \
        checked_cumprod(prod.reshape(runs, run_len), axis=1).reshape(-1)
    check_range(acc)
    ctx.write(cfg.a2, r, acc)
    init_rows = r + np.arange(runs) * run_len
    init_gate = {"dot": "dot_init", "sum": "sum_init", "prod": "prod_init"}[kind]
    sel_init = ctx._arr(cfg.sel[init_gate])
    sel_rest = ctx._arr(cfg.sel[kind])
    mask = np.zeros(L, bool)
    mask[np.arange(runs) * run_len] = True
    rows_all = r + np.arange(L)
    sel_init[rows_all[mask]] = 1
    sel_rest[rows_all[~mask]] = 1
    out_rows = r + np.arange(runs) * run_len + (run_len - 1)
    out_vals = acc.reshape(runs, run_len)[:, -1]
    return out_vals, out_rows


def matmul(ctx: LayoutCtx, a: TVal, b: TVal) -> TVal:
    """(.., M, K) x (K, N) -> (.., M, N) via dot-accumulation runs.

    The reference routes einsums either to Freivalds or base-op dots
    (`chip/einsum/analysis.rs`); this is the base-op path.
    """
    A, B = a.ints, b.ints
    assert A.shape[-1] == B.shape[0], f"matmul dims {A.shape} x {B.shape}"
    lead = A.shape[:-2] if A.ndim > 1 else ()
    M = A.shape[-2] if A.ndim >= 2 else 1
    K = A.shape[-1]
    N = B.shape[1] if B.ndim == 2 else 1
    batch = int(np.prod(lead, dtype=np.int64)) or 1
    # flat index arrays for each (batch, i, j, k) row
    bidx, iidx, jidx, kidx = np.meshgrid(
        np.arange(batch), np.arange(M), np.arange(N), np.arange(K),
        indexing="ij")
    idx_a = ((bidx * M + iidx) * K + kidx).reshape(-1)
    idx_b = (kidx * N + jidx).reshape(-1)
    runs = batch * M * N
    out_vals, out_rows = _accumulate(ctx, "dot", idx_a, idx_b, a, b, runs, K)
    out_shape = lead + (M, N) if A.ndim >= 2 else (N,)
    if B.ndim == 1:
        out_shape = lead + (M,)
    return TVal(out_vals.reshape(out_shape), a.scale + b.scale,
                Span(ctx.cfg.a2, out_rows))


def sum_reduce(ctx: LayoutCtx, a: TVal) -> TVal:
    """Full sum() of a tensor -> scalar (shape ())."""
    L = int(a.ints.size)
    out_vals, out_rows = _accumulate(
        ctx, "sum", np.arange(L), None, a, None, 1, L)
    return TVal(out_vals.reshape(()), a.scale, Span(ctx.cfg.a2, out_rows))


# ---------------------------------------------------------------------------
# nonlinearities via lookup (reference `lookup.rs` + nonlinearities)
# ---------------------------------------------------------------------------

def _table_range(ctx: LayoutCtx, lookup_range) -> np.ndarray:
    lo, hi = lookup_range
    n_needed = hi - lo + 1
    # Tables larger than the usable rows split into chunked column sets
    # (layout.py ensure_table), capped at MAX_LOOKUP_COLS chunks — the
    # same bound gen_settings sizes min_k against (graph/circuit.py).
    from ..plonk.cs import MAX_LOOKUP_COLS
    if n_needed > MAX_LOOKUP_COLS * ctx.usable:
        raise ValueError(
            f"lookup table of {n_needed} rows exceeds {MAX_LOOKUP_COLS} "
            f"chunks of {ctx.usable} usable rows (2^{ctx.k} domain); "
            "raise logrows or shrink lookup_range")
    return np.arange(lo, hi + 1, dtype=np.int64)


def lookup_fn(ctx: LayoutCtx, name: str, a: TVal, fn, in_scale: int,
              out_scale: int, lookup_range) -> TVal:
    """Generic quantized nonlinearity: out = quant(fn(dequant(in))).

    Table values are memoized on disk keyed by the fully-qualified table
    name (op + scales + range; `name` carries every parameter that `fn`
    bakes in, as `leaky{alpha}` and `elu{alpha}` do) — the analog of the
    reference's lookup-table cache (`ezkl/src/circuit/table.rs:31-39`).
    The build here is one vectorized numpy pass, so the cache mostly saves
    the transcendental evals of multi-million-row tables on repeat runs."""
    xs = _table_range(ctx, lookup_range)
    tname = f"{name}_si{in_scale}_so{out_scale}_r{lookup_range[0]}_{lookup_range[1]}"
    ys = _table_cache_load(tname, xs.size)
    if ys is None:
        with np.errstate(all="ignore"):
            ys = quantize(fn(dequantize(xs, in_scale)), out_scale)
        ys = np.nan_to_num(ys, nan=0.0, posinf=0, neginf=0).astype(np.int64)
        _table_cache_store(tname, ys)
    return ctx.apply_lookup(tname, xs, ys, a, out_scale)


def _table_cache_dir():
    import pathlib
    from .. import cache_dir
    return pathlib.Path(cache_dir()) / "tables"


def _table_cache_load(tname: str, n: int):
    if os.environ.get("EZKL_TPU_NO_TABLE_CACHE"):
        return None
    f = _table_cache_dir() / f"{tname}.npy"
    try:
        ys = np.load(f, allow_pickle=False)
        if ys.shape == (n,) and ys.dtype == np.int64:
            return ys
    except (OSError, ValueError):
        pass
    return None


def _table_cache_store(tname: str, ys: np.ndarray):
    if os.environ.get("EZKL_TPU_NO_TABLE_CACHE") or ys.size < (1 << 16):
        return  # small tables rebuild faster than they load
    d = _table_cache_dir()
    try:
        d.mkdir(parents=True, exist_ok=True)
        # a per-process temporary name: concurrent runs never write into
        # one file before it replaces the table
        tmp = d / f".{tname}.{os.getpid()}.tmp.npy"
        np.save(tmp, ys, allow_pickle=False)
        tmp.replace(d / f"{tname}.npy")
    except OSError:
        pass


def relu(ctx, a: TVal, lookup_range) -> TVal:
    return lookup_fn(ctx, "relu", a, lambda x: np.maximum(x, 0.0),
                     a.scale, a.scale, lookup_range)


def sigmoid(ctx, a: TVal, out_scale: int, lookup_range) -> TVal:
    return lookup_fn(ctx, "sigmoid", a, lambda x: 1.0 / (1.0 + np.exp(-x)),
                     a.scale, out_scale, lookup_range)


def exp_op(ctx, a: TVal, out_scale: int, lookup_range) -> TVal:
    return lookup_fn(ctx, "exp", a, np.exp, a.scale, out_scale, lookup_range)


def tanh_op(ctx, a: TVal, out_scale: int, lookup_range) -> TVal:
    return lookup_fn(ctx, "tanh", a, np.tanh, a.scale, out_scale, lookup_range)


def div_known(ctx: LayoutCtx, a: TVal, d: int, out_scale: int) -> TVal:
    """Rounded division by a known positive integer d via the claimed-
    quotient construction (reference `layouts.rs` div: witness the quotient,
    constrain x = q*d + r with |r| <= d/2 by a range lookup). No bound on
    the input magnitude — unlike a table-based division."""
    cfg = ctx.cfg
    assert d >= 1
    if d == 1:
        return TVal(a.ints, out_scale, a.span)
    x = a.ints.reshape(-1)
    q = np.rint(x / d).astype(np.int64)
    r = x - q * d
    h = d // 2
    # q*d (mul gate with the constant d)
    dconst = TVal(np.full(1, d, np.int64), 0, None)
    qv = TVal(q, 0, None, witness=True)  # claimed quotient: MUST be advice
    prod = pairwise(ctx, "mul", qv, dconst)
    # recover q's span: it was staged as operand a0 of the mul
    q_span = Span.contiguous(cfg.a0, int(prod.span.rows[0]), q.size)
    # r = x - q*d (sub gate): a0 = x, a1 = prod, a2 = r
    L = q.size
    rr = ctx.alloc(L)
    ctx.stage_operand(a, cfg.a0, rr, np.arange(L))
    ctx.stage_operand(prod, cfg.a1, rr, np.arange(L))
    ctx.write(cfg.a2, rr, r)
    ctx.enable("sub", rr, L)
    rtv = TVal(r, 0, Span.contiguous(cfg.a2, rr, L))
    # range-check r in [-h, h] via an identity-pair lookup table
    tbl = np.arange(-h, h + 1, dtype=np.int64)
    ctx.apply_lookup(f"range_pm{h}", tbl, tbl, rtv, 0)
    return TVal(q.reshape(a.shape), out_scale, q_span)


def div_rebase(ctx, a: TVal, shift: int, lookup_range=None) -> TVal:
    """Divide by 2^shift with rounding (the RebaseScale divisor,
    reference `node.rs:142-290`)."""
    return div_known(ctx, a, 1 << shift, a.scale - shift)


# ---------------------------------------------------------------------------
# index ops — free (span row permutations), with a column-merge fallback
# ---------------------------------------------------------------------------

def identity_move(ctx: LayoutCtx, a: TVal) -> TVal:
    """Copy a tensor into a fresh contiguous a2 span via the sum_init gate
    (a2 = a0). Used to merge tensors from different columns."""
    cfg = ctx.cfg
    L = int(a.ints.size)
    r = ctx.alloc(L)
    ctx.stage_operand(a, cfg.a0, r, np.arange(L))
    ctx.write(cfg.a2, r, a.ints)
    ctx.enable("sum_init", r, L)
    return TVal(a.ints.copy(), a.scale, Span.contiguous(cfg.a2, r, L))


def reindex(tv: TVal, flat_idx: np.ndarray, new_shape) -> TVal:
    """Pure element re-ordering/selection (gather with static indices):
    transpose, slice, flip, repeat... — zero constraints."""
    return TVal(tv.ints.reshape(-1)[flat_idx].reshape(new_shape), tv.scale,
                Span(tv.span.col, tv.span.rows[flat_idx]) if tv.span else None)


def transpose(ctx, a: TVal, perm) -> TVal:
    idx = np.arange(a.ints.size).reshape(a.shape).transpose(perm).reshape(-1)
    return reindex(a, idx, tuple(a.shape[p] for p in perm))


def concat(ctx: LayoutCtx, tvs: list[TVal], axis: int) -> TVal:
    tvs = [tv if tv.span is not None else _mat(ctx, tv) for tv in tvs]
    cols = {id(tv.span.col) for tv in tvs}
    if len(cols) > 1:
        tvs = [identity_move(ctx, tv) for tv in tvs]
    col = tvs[0].span.col
    out_ints = np.concatenate([tv.ints for tv in tvs], axis=axis)
    # rows follow the same concatenation order
    row_grids = [tv.span.rows.reshape(tv.shape) for tv in tvs]
    rows = np.concatenate(row_grids, axis=axis).reshape(-1)
    return TVal(out_ints, tvs[0].scale, Span(col, rows))


def _mat(ctx, tv):
    ctx.materialize(tv)
    return tv


def pad(ctx: LayoutCtx, a: TVal, pads, value: int = 0) -> TVal:
    """Zero-pad: pad cells point at a shared zero cell in c_fixed."""
    zero = TVal(np.full(1, value, np.int64), a.scale, None)
    zspan = ctx.materialize(zero)
    a = _mat(ctx, a)
    if id(a.span.col) != id(zspan.col):
        # keep zero in the same column as `a` by moving a if needed; cheaper:
        # move the single zero cell via identity into a's column? identity
        # lands in a2 — so move BOTH into a2 when columns differ.
        if id(a.span.col) != id(ctx.cfg.a2):
            a = identity_move(ctx, a)
        z2 = identity_move(ctx, TVal(zero.ints, a.scale, zspan))
        zspan = z2.span
    rows_grid = a.span.rows.reshape(a.shape)
    padded_rows = np.pad(rows_grid, pads, constant_values=zspan.rows[0])
    padded_ints = np.pad(a.ints, pads, constant_values=value)
    return TVal(padded_ints, a.scale, Span(a.span.col, padded_rows.reshape(-1)))


# ---------------------------------------------------------------------------
# general einsum (base-op dot accumulation; reference `layouts.rs:887`)
# ---------------------------------------------------------------------------

def einsum(ctx: LayoutCtx, equation: str, a: TVal, b: TVal | None = None) -> TVal:
    """Two-operand (or one-operand) einsum via dot/sum accumulation runs."""
    eq = equation.replace(" ", "")
    lhs, rhs = eq.split("->")
    terms = lhs.split(",")
    dims: dict[str, int] = {}
    shapes = [a.shape] + ([b.shape] if b is not None else [])
    for term, shape in zip(terms, shapes):
        assert len(term) == len(shape), f"einsum {eq} vs {shape}"
        for ch, s in zip(term, shape):
            dims.setdefault(ch, s)
            assert dims[ch] == s, f"einsum dim mismatch {ch}"
    out_chars = list(rhs)
    red_chars = [c for c in dims if c not in out_chars]
    out_shape = tuple(dims[c] for c in out_chars)
    red_shape = tuple(dims[c] for c in red_chars)
    runs = int(np.prod(out_shape, dtype=np.int64)) or 1
    run_len = int(np.prod(red_shape, dtype=np.int64)) or 1

    grids = np.meshgrid(*[np.arange(dims[c]) for c in out_chars + red_chars],
                        indexing="ij") if (out_chars + red_chars) else []
    coord = {c: g for c, g in zip(out_chars + red_chars, grids)}

    def flat_index(term, shape):
        idx = np.zeros(tuple(dims[c] for c in out_chars + red_chars), np.int64)
        stride = 1
        for ch, s in zip(reversed(term), reversed(shape)):
            idx = idx + coord[ch] * stride
            stride *= s
        return idx.reshape(-1)

    idx_a = flat_index(terms[0], a.shape)
    if b is not None:
        idx_b = flat_index(terms[1], b.shape)
        out_vals, out_rows = _accumulate(ctx, "dot", idx_a, idx_b, a, b,
                                         runs, run_len)
        scale = a.scale + b.scale
    else:
        out_vals, out_rows = _accumulate(ctx, "sum", idx_a, None, a, None,
                                         runs, run_len)
        scale = a.scale
    return TVal(out_vals.reshape(out_shape), scale, Span(ctx.cfg.a2, out_rows))


# ---------------------------------------------------------------------------
# convolution / pooling (reference `layouts.rs:4499,3907,4008`)
# ---------------------------------------------------------------------------

def conv2d(ctx: LayoutCtx, x: TVal, w: TVal, bias: TVal | None,
           strides=(1, 1), padding=(0, 0, 0, 0), lookup_range=None,
           matmul_fn=None, dilations=(1, 1)) -> TVal:
    """NCHW conv via padding + im2col reindex + one big matmul (which the
    model layer may route through the Freivalds phase-2 argument)."""
    N, C, H, W_ = x.shape
    O, Ci, KH, KW = w.shape
    assert Ci == C, f"conv channels {Ci} != {C}"
    pt, pl, pb, pr = padding
    if any(padding):
        x = pad(ctx, x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    _, _, Hp, Wp = x.shape
    sh, sw = strides
    dh, dw = dilations
    OH = (Hp - (KH - 1) * dh - 1) // sh + 1
    OW = (Wp - (KW - 1) * dw - 1) // sw + 1
    # im2col as a pure reindex: patches (N*OH*OW, C*KH*KW)
    n_i, oh, ow, c_i, kh, kw = np.meshgrid(
        np.arange(N), np.arange(OH), np.arange(OW), np.arange(C),
        np.arange(KH), np.arange(KW), indexing="ij")
    src = (((n_i * C + c_i) * Hp + (oh * sh + kh * dh)) * Wp
           + (ow * sw + kw * dw))
    patches = reindex(x, src.reshape(-1), (N * OH * OW, C * KH * KW))
    # weights as (C*KH*KW, O): transposed reindex of the placed tensor
    wm = w.ints.reshape(O, C * KH * KW)
    wt_idx = np.arange(wm.size).reshape(wm.shape).T.reshape(-1)
    wmat = reindex(TVal(wm, w.scale, w.span), wt_idx, (C * KH * KW, O))
    mm = matmul_fn or matmul
    out2d = mm(ctx, patches, wmat)                    # (N*OH*OW, O)
    # (N, OH, OW, O) -> (N, O, OH, OW)
    perm_idx = np.arange(out2d.ints.size).reshape(
        (N, OH, OW, O)).transpose(0, 3, 1, 2).reshape(-1)
    out = reindex(out2d, perm_idx, (N, O, OH, OW))
    if bias is not None:
        bb = TVal(bias.ints.reshape(1, O, 1, 1), bias.scale, bias.span)
        out = pairwise(ctx, "add", out, bb)
    return out


def sumpool2d(ctx, x: TVal, kernel, strides, padding=(0, 0, 0, 0)) -> TVal:
    N, C, H, W_ = x.shape
    KH, KW = kernel
    pt, pl, pb, pr = padding
    if any(padding):
        x = pad(ctx, x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    _, _, Hp, Wp = x.shape
    sh, sw = strides
    OH = (Hp - KH) // sh + 1
    OW = (Wp - KW) // sw + 1
    n_i, c_i, oh, ow, kh, kw = np.meshgrid(
        np.arange(N), np.arange(C), np.arange(OH), np.arange(OW),
        np.arange(KH), np.arange(KW), indexing="ij")
    src = ((n_i * C + c_i) * Hp + (oh * sh + kh)) * Wp + (ow * sw + kw)
    patches = reindex(x, src.reshape(-1), (N, C, OH, OW, KH * KW))
    return einsum(ctx, "nchwk->nchw", patches)


def maxpool2d(ctx, x: TVal, kernel, strides, padding, lookup_range) -> TVal:
    """max over window via iterated pairwise max: max(a,b) = a + relu(b-a)
    (reference builds max from comparisons too, `layouts.rs:4008`)."""
    N, C, H, W_ = x.shape
    KH, KW = kernel
    pt, pl, pb, pr = padding
    if any(padding):
        x = pad(ctx, x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    _, _, Hp, Wp = x.shape
    sh, sw = strides
    OH = (Hp - KH) // sh + 1
    OW = (Wp - KW) // sw + 1
    n_i, c_i, oh, ow = np.meshgrid(np.arange(N), np.arange(C),
                                   np.arange(OH), np.arange(OW), indexing="ij")
    acc = None
    for kh in range(KH):
        for kw in range(KW):
            src = ((n_i * C + c_i) * Hp + (oh * sh + kh)) * Wp + (ow * sw + kw)
            elem = reindex(x, src.reshape(-1), (N, C, OH, OW))
            acc = elem if acc is None else pairwise_max(ctx, acc, elem, lookup_range)
    return acc


def pairwise_max(ctx, a: TVal, b: TVal, lookup_range) -> TVal:
    diff = pairwise(ctx, "sub", b, a)
    r = relu(ctx, diff, lookup_range)
    return pairwise(ctx, "add", a, r)


def upsample_zeros(ctx: LayoutCtx, x: TVal, stride: tuple) -> TVal:
    """Insert (stride-1) zeros between spatial pixels of NCHW x (deconv
    prelude). Zero cells alias one shared zero cell."""
    N, C, H, W_ = x.shape
    sh, sw = stride
    if sh == 1 and sw == 1:
        return x
    zero = TVal(np.zeros(1, np.int64), x.scale, None)
    x = _mat(ctx, x)
    zspan = ctx.materialize(zero)
    if id(x.span.col) != id(zspan.col):
        if id(x.span.col) != id(ctx.cfg.a2):
            x = identity_move(ctx, x)
        z2 = identity_move(ctx, TVal(zero.ints, x.scale, zspan))
        zspan = z2.span
    OH, OW = (H - 1) * sh + 1, (W_ - 1) * sw + 1
    rows = np.full((N, C, OH, OW), zspan.rows[0], np.int64)
    ints = np.zeros((N, C, OH, OW), np.int64)
    grid = x.span.rows.reshape(x.shape)
    rows[:, :, ::sh, ::sw] = grid
    ints[:, :, ::sh, ::sw] = x.ints
    return TVal(ints, x.scale, Span(x.span.col, rows.reshape(-1)))


def deconv2d(ctx: LayoutCtx, x: TVal, w: TVal, bias, strides, padding,
             output_padding=(0, 0), matmul_fn=None) -> TVal:
    """ConvTranspose via zero-upsampling + conv with the flipped kernel
    (reference `layouts.rs:4297`). w: (C_in, O, KH, KW) per ONNX."""
    C, O, KH, KW = w.shape
    up = upsample_zeros(ctx, x, strides)
    # flip spatial dims + swap in/out channels -> (O, C, KH, KW)
    wf = np.flip(w.ints, axis=(2, 3)).transpose(1, 0, 2, 3)
    if w.span is not None:
        idx = np.flip(np.arange(w.ints.size).reshape(w.shape),
                      axis=(2, 3)).transpose(1, 0, 2, 3).reshape(-1)
        wt = TVal(np.ascontiguousarray(wf), w.scale,
                  Span(w.span.col, w.span.rows[idx]))
    else:
        wt = TVal(np.ascontiguousarray(wf), w.scale, None)
    pt, pl, pb, pr = padding
    opad_h, opad_w = output_padding
    pad2 = (KH - 1 - pt, KW - 1 - pl, KH - 1 - pb + opad_h, KW - 1 - pr + opad_w)
    return conv2d(ctx, up, wt, bias, (1, 1), pad2, matmul_fn=matmul_fn)


def resize_nearest(ctx: LayoutCtx, x: TVal, scales) -> TVal:
    """Nearest-neighbor upsample: pure reindex."""
    idx_grids = np.meshgrid(
        *[np.minimum((np.arange(int(round(s * d))) / s).astype(np.int64), d - 1)
          for d, s in zip(x.shape, scales)], indexing="ij")
    flat = np.zeros(idx_grids[0].shape, np.int64)
    stride = 1
    for g, d in zip(reversed(idx_grids), reversed(x.shape)):
        flat = flat + g * stride
        stride *= d
    return reindex(x, flat.reshape(-1), idx_grids[0].shape)


# ---------------------------------------------------------------------------
# comparisons / logic (reference `layouts.rs:3112-3544`)
# ---------------------------------------------------------------------------

def _fits_table(vals: np.ndarray, lookup_range) -> bool:
    lo, hi = lookup_range
    return vals.size == 0 or (int(vals.min()) >= lo and int(vals.max()) <= hi)


def greater(ctx, a: TVal, b: TVal, lookup_range, decomp=None) -> TVal:
    """(a > b). Table path when the difference fits `lookup_range`; with
    `decomp=(base, legs)` falls back to the decompose path for ranges up to
    base**legs (reference routes comparisons through sign/decompose,
    `layouts.rs:3112-3544`)."""
    diff = pairwise(ctx, "sub", a, b)
    if decomp is not None and not _fits_table(diff.ints, lookup_range):
        s = sign_decomp(ctx, diff, *decomp)
        return _bit_from_sign(ctx, s, positive=True)
    out = lookup_fn(ctx, "step_pos", diff, lambda x: (x > 0).astype(np.float64),
                    diff.scale, 0, lookup_range)
    return out


def less(ctx, a, b, lookup_range, decomp=None):
    return greater(ctx, b, a, lookup_range, decomp)


def equals(ctx, a: TVal, b: TVal, lookup_range, decomp=None) -> TVal:
    diff = pairwise(ctx, "sub", a, b)
    if decomp is not None and not _fits_table(diff.ints, lookup_range):
        return equals_zero(ctx, diff)
    return lookup_fn(ctx, "is_zero", diff,
                     lambda x: (x == 0).astype(np.float64),
                     diff.scale, 0, lookup_range)


def iff(ctx, cond: TVal, a: TVal, b: TVal) -> TVal:
    """cond in {0,1}: cond*a + (1-cond)*b  (reference PolyOp::Iff)."""
    assert cond.scale == 0
    one = TVal(np.ones(1, np.int64), 0, None)
    notc = pairwise(ctx, "sub", one, cond)
    return pairwise(ctx, "add", pairwise(ctx, "mul", cond, a),
                    pairwise(ctx, "mul", notc, b))


def logical(ctx, kind: str, a: TVal, b: TVal | None = None) -> TVal:
    one = TVal(np.ones(1, np.int64), 0, None)
    if kind == "not":
        return pairwise(ctx, "sub", one, a)
    if kind == "and":
        return pairwise(ctx, "mul", a, b)
    ab = pairwise(ctx, "mul", a, b)
    s = pairwise(ctx, "add", a, b)
    if kind == "or":
        return pairwise(ctx, "sub", s, ab)
    if kind == "xor":
        two_ab = pairwise(ctx, "add", ab, ab)
        return pairwise(ctx, "sub", s, two_ab)
    raise ValueError(kind)


def pow_int(ctx, a: TVal, e: int) -> TVal:
    """a^e for small static integer e by square-and-multiply muls."""
    assert e >= 1
    acc = None
    base = a
    ee = e
    while ee:
        if ee & 1:
            acc = base if acc is None else pairwise(ctx, "mul", acc, base)
        ee >>= 1
        if ee:
            base = pairwise(ctx, "mul", base, base)
    return acc


# ---------------------------------------------------------------------------
# decompose / recompose family (reference `layouts.rs:6321-6423`, `:5024`,
# `:6201`) — lookup-free sign/abs/comparisons whose range is base**legs
# instead of the lookup-table size.
# ---------------------------------------------------------------------------

def range_check(ctx: LayoutCtx, a: TVal, lo: int, hi: int) -> TVal:
    """Constrain every element of `a` into [lo, hi] via an identity-pair
    lookup table (our logup analog of the reference's RangeCheck chip,
    `table.rs:326`)."""
    tbl = np.arange(lo, hi + 1, dtype=np.int64)
    return ctx.apply_lookup(f"range_{lo}_{hi}", tbl, tbl, a, a.scale)


def equals_zero(ctx: LayoutCtx, a: TVal) -> TVal:
    """iz = (x == 0) via a witnessed field inverse (`layouts.rs:3549`):

        u  = x * xi         (xi := x^{-1} in Fr, or 0)   [mul gate]
        iz = 1 - u                                        [sub gate]
        x * iz = 0          (a2 copy-constrained to a fixed 0 cell)

    Sound: x != 0 forces iz = 0 then u = 1 so xi = x^{-1}; x = 0 forces
    u = 0, iz = 1. The inverse is a full-width field element and lives in
    the overlay (`LayoutCtx.write_field`)."""
    from ..fieldmath.spec import FR_MODULUS as P

    cfg = ctx.cfg
    x = a.ints.reshape(-1)
    L = int(x.size)
    ar = np.arange(L)
    u = (x != 0).astype(np.int64)
    iz = 1 - u

    # u = x * xi
    r1 = ctx.alloc(L)
    ctx.stage_operand(a, cfg.a0, r1, ar)
    xi = [pow(int(v) % P, -1, P) if v else 0 for v in x]
    ctx.write_field(cfg.a1, r1, xi)
    ctx.write(cfg.a2, r1, u)
    ctx.enable("mul", r1, L)

    # iz = 1 - u
    one = TVal(np.ones(1, np.int64), 0, None)
    r2 = ctx.alloc(L)
    ctx.stage_operand(one, cfg.a0, r2, np.zeros(L, np.int64))
    ctx.write(cfg.a1, r2, u)
    ctx.copy_rows(cfg.a1, r2 + ar, cfg.a2, r1 + ar)
    ctx.write(cfg.a2, r2, iz)
    ctx.enable("sub", r2, L)

    # x * iz == 0
    r3 = ctx.alloc(L)
    ctx.stage_operand(a, cfg.a0, r3, ar)
    ctx.write(cfg.a1, r3, iz)
    ctx.copy_rows(cfg.a1, r3 + ar, cfg.a2, r2 + ar)
    ctx.write(cfg.a2, r3, np.zeros(L, np.int64))
    ctx.enable("mul", r3, L)
    zero = TVal(np.zeros(1, np.int64), 0, None)
    zspan = ctx.materialize(zero)
    ctx.copy_rows(cfg.a2, r3 + ar, zspan.col,
                  np.broadcast_to(zspan.rows[:1], (L,)))

    return TVal(iz.reshape(a.shape), 0, Span.contiguous(cfg.a2, r2, L))


def decompose(ctx: LayoutCtx, a: TVal, base: int, legs: int,
              zero_sign_matters: bool = True):
    """Claimed sign-and-digit decomposition (reference `layouts.rs:6321`).

    Witnesses sign s in {-1,0,1} and big-endian digits d_j in [0, base) with
    x = s * sum_j d_j * base^(legs-1-j); range-checks both, recomposes with
    dot gates, and copy-constrains the recomposition to x. With
    `zero_sign_matters`, additionally enforces isZero(x) * s == 0.

    Returns (sign_tv, digits_tv, abs_tv); abs_tv carries a's scale.
    """
    cfg = ctx.cfg
    x = a.ints.reshape(-1)
    L = int(x.size)
    limit = base ** legs
    if L and int(np.abs(x).max()) >= limit:
        raise ValueError(
            f"decompose: |x| up to {np.abs(x).max()} exceeds base^legs = "
            f"{limit}; raise decomp_base/decomp_legs")
    s = np.sign(x).astype(np.int64)
    mag = np.abs(x)
    digs = np.zeros((L, legs), np.int64)
    m = mag.copy()
    for j in range(legs - 1, -1, -1):
        digs[:, j] = m % base
        m //= base

    d_tv = range_check(ctx, TVal(digs, 0, None, witness=True), 0, base - 1)
    s_tv = range_check(ctx, TVal(s, 0, None, witness=True), -1, 1)

    # |x| = digits . [base^(legs-1), .., base, 1] per element (dot runs)
    pows = np.array([base ** (legs - 1 - j) for j in range(legs)], np.int64)
    pw_tv = TVal(np.broadcast_to(pows, (L, legs)).copy(), 0, None)
    idx = np.arange(L * legs)
    out_vals, out_rows = _accumulate(ctx, "dot", idx, idx, d_tv, pw_tv,
                                     L, legs)
    abs_tv = TVal(out_vals, a.scale, Span(cfg.a2, out_rows))

    # s * |x| == x (mul gate, output copy-constrained to x's home)
    signed = pairwise(ctx, "mul", s_tv, abs_tv)
    src = ctx.materialize(a)
    ctx.copy_rows(signed.span.col, signed.span.rows, src.col, src.rows)

    if zero_sign_matters:
        iz = equals_zero(ctx, a)
        sz = pairwise(ctx, "mul", s_tv, iz)
        zero = TVal(np.zeros(1, np.int64), 0, None)
        zspan = ctx.materialize(zero)
        ctx.copy_rows(sz.span.col, sz.span.rows, zspan.col,
                      np.broadcast_to(zspan.rows[:1], (L,)))

    s_out = TVal(s.reshape(a.shape), 0, s_tv.span)
    abs_out = TVal(mag.reshape(a.shape), a.scale, abs_tv.span)
    return s_out, d_tv, abs_out


def sign_decomp(ctx: LayoutCtx, a: TVal, base: int, legs: int) -> TVal:
    """sign(x) in {-1,0,1} via decomposition — no table-range limit
    (reference Sign is decompose-based, `poly.rs` Sign -> `layouts.rs`)."""
    s, _, _ = decompose(ctx, a, base, legs, zero_sign_matters=True)
    return s


def abs_decomp(ctx: LayoutCtx, a: TVal, base: int, legs: int) -> TVal:
    """|x| via decomposition (sign of 0 is free — |0| = 0 either way)."""
    _, _, ab = decompose(ctx, a, base, legs, zero_sign_matters=False)
    return ab


def _bit_from_sign(ctx: LayoutCtx, s: TVal, positive: bool) -> TVal:
    """Map s in {-1,0,1} to the bit (s == 1) (or (s == -1)): witness g,
    constrain g in {0,1} via range check and 2g == s^2 +/- s with gates."""
    cfg = ctx.cfg
    sv = s.ints.reshape(-1)
    L = int(sv.size)
    ar = np.arange(L)
    g = (sv == (1 if positive else -1)).astype(np.int64)
    g_tv = range_check(ctx, TVal(g, 0, None, witness=True), 0, 1)
    t = pairwise(ctx, "mul", s, s)                       # s^2
    u = pairwise(ctx, "add" if positive else "sub", t, s)  # s^2 +/- s
    # 2g == u: add gate with a0 = a1 = g, a2 copy-constrained to u
    r = ctx.alloc(L)
    ctx.stage_operand(g_tv, cfg.a0, r, ar)
    ctx.stage_operand(g_tv, cfg.a1, r, ar)
    ctx.write(cfg.a2, r, 2 * g)
    ctx.enable("add", r, L)
    ctx.copy_rows(cfg.a2, r + ar, u.span.col, u.span.rows)
    return TVal(g.reshape(s.shape), 0, g_tv.span)


def greater_decomp(ctx: LayoutCtx, a: TVal, b: TVal, base: int,
                   legs: int) -> TVal:
    """(a > b) with range base**legs (reference comparison family,
    `layouts.rs:3112-3544`, routed through sign/decompose)."""
    d = pairwise(ctx, "sub", a, b)
    s = sign_decomp(ctx, d, base, legs)
    return _bit_from_sign(ctx, s, positive=True)


def less_decomp(ctx, a, b, base, legs):
    return greater_decomp(ctx, b, a, base, legs)


def equals_decomp(ctx: LayoutCtx, a: TVal, b: TVal) -> TVal:
    """(a == b) via the witnessed-inverse isZero — no range limit at all."""
    d = pairwise(ctx, "sub", a, b)
    return equals_zero(ctx, d)

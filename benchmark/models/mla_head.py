"""One head of a DeepSeek-V3-style latent attention (MLA) layer with no q
LoRA, over a chunk of positions from 0 with no earlier cache: the share of
one of `num_heads` tensor-parallel provers of a split LLM-inference proof.

The input row of each position is `[h | c_kv | k_pe]`: the RMS-normed hidden
state and the raw output of `kv_a_proj_with_mqa` (before `kv_a_layernorm`
and before RoPE). For the head:

    q = h W_q                      -> [q_nope | q_pe], W_q holding 1/sqrt(d_qk)
    c = RMSNorm(c_kv) * gamma      (Mul, ReduceMean, Add eps, Sqrt, Reciprocal)
    q_pe, k_pe <- RoPE             (rope dims de-interleaved, then rotate_half)
    [k_nope | v] = c W_kvb
    p = softmax(q k^T + mask)      q = [q_nope | q_pe], k = [k_nope | k_pe]
    y = (p v) W_o                  (S, hidden): summed over heads, the layer

The mask is added: 0 on and below the diagonal, `mask_value` above it, whose
exp rounds to exactly 0 at the fixed-point scale.

`build` writes the ONNX model; `forward` is the plain reference in numpy
int64 at the run arguments' scales, rounding as the circuit does (module
`fixed`, and below). It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

from .. import onnx_writer as w
from .fixed import quantize, rounded_div


def widths(cfg: dict) -> dict:
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    return {"S": cfg["input_shape"][0], "H": cfg["hidden_size"], "L": cfg["kv_lora_rank"],
            "N": nope, "R": rope, "V": cfg["v_head_dim"], "D": nope + rope}


def rope_tables(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """cos and sin of positions 0..S-1 as DeepSeek-V3's rotary embedding
    builds them: inv_freq over the even dims, the frequencies repeated."""
    d = widths(cfg)
    inv = 1.0 / (cfg["rope_theta"] ** (np.arange(0, d["R"], 2, dtype=np.float64) / d["R"]))
    freqs = np.outer(np.arange(d["S"], dtype=np.float64), inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def causal_mask(cfg: dict) -> np.ndarray:
    s = widths(cfg)["S"]
    return np.triu(np.full((s, s), cfg["mask_value"], np.float32), 1)


def draw_weights(cfg: dict, rng: np.random.Generator) -> dict:
    """The head's slices: W_q (H, D) with the softmax scale 1/sqrt(D) folded
    in, W_kvb (L, N + V), W_o (V, H), and kv_a_layernorm's gamma (L,)."""
    d, dr = widths(cfg), cfg["draws"]
    wq = rng.normal(0.0, dr["q_weight_std"], (d["H"], d["D"]))
    return {
        "wq": (wq / np.sqrt(d["D"])).astype(np.float32),
        "wkvb": rng.normal(0.0, dr["kv_b_weight_std"],
                           (d["L"], d["N"] + d["V"])).astype(np.float32),
        "wo": rng.normal(0.0, dr["o_weight_std"], (d["V"], d["H"])).astype(np.float32),
        "gamma": rng.uniform(dr["gamma_low"], dr["gamma_high"], (d["L"],)).astype(np.float32),
    }


def _rope_nodes(src: str, out: str, d: dict) -> list:
    """RoPE of (S, R) `src`: de-interleave, then x cos + rotate_half(x) sin."""
    r, half = d["R"], d["R"] // 2
    return [
        w.node("Reshape", [src, "shape_pairs"], [f"{out}_pairs"], name=f"{out}_pairs"),
        w.node("Transpose", [f"{out}_pairs"], [f"{out}_tp"], name=f"{out}_tp", perm=[0, 2, 1]),
        w.node("Reshape", [f"{out}_tp", "shape_rope"], [f"{out}_d"], name=f"{out}_d"),
        w.node("Slice", [f"{out}_d"], [f"{out}_x1"], name=f"{out}_x1",
               starts=[0], ends=[half], axes=[1]),
        w.node("Slice", [f"{out}_d"], [f"{out}_x2"], name=f"{out}_x2",
               starts=[half], ends=[r], axes=[1]),
        w.node("Neg", [f"{out}_x2"], [f"{out}_nx2"], name=f"{out}_nx2"),
        w.node("Concat", [f"{out}_nx2", f"{out}_x1"], [f"{out}_rot"], name=f"{out}_rot", axis=1),
        w.node("Mul", [f"{out}_d", "rope_cos"], [f"{out}_c"], name=f"{out}_c"),
        w.node("Mul", [f"{out}_rot", "rope_sin"], [f"{out}_s"], name=f"{out}_s"),
        w.node("Add", [f"{out}_c", f"{out}_s"], [out], name=out),
    ]


def build(cfg: dict, weights: dict) -> bytes:
    d = widths(cfg)
    S, H, L, N, R, D = d["S"], d["H"], d["L"], d["N"], d["R"], d["D"]

    def cols(src, out, lo, hi):
        return w.node("Slice", [src], [out], name=out, starts=[lo], ends=[hi], axes=[1])

    nodes = [
        cols("x", "h", 0, H), cols("x", "ckv", H, H + L), cols("x", "kpe", H + L, H + L + R),
        w.node("MatMul", ["h", "wq"], ["q"], name="q_proj"),
        cols("q", "q_nope", 0, N), cols("q", "q_pe", N, D),
        # kv_a_layernorm: c * 1/sqrt(mean(c^2) + eps) * gamma
        w.node("Mul", ["ckv", "ckv"], ["ckv_sq"], name="ckv_sq"),
        w.node("ReduceMean", ["ckv_sq"], ["ckv_ms"], name="ckv_ms", axes=[1], keepdims=1),
        w.node("Add", ["ckv_ms", "eps"], ["ckv_mse"], name="ckv_mse"),
        w.node("Sqrt", ["ckv_mse"], ["ckv_rms"], name="ckv_rms"),
        w.node("Reciprocal", ["ckv_rms"], ["ckv_inv"], name="ckv_inv"),
        w.node("Mul", ["ckv", "ckv_inv"], ["ckv_n"], name="ckv_n"),
        w.node("Mul", ["ckv_n", "gamma"], ["c"], name="kv_a_layernorm"),
        w.node("MatMul", ["c", "wkvb"], ["kv"], name="kv_b_proj"),
        cols("kv", "k_nope", 0, N), cols("kv", "v", N, N + d["V"]),
        *_rope_nodes("q_pe", "q_rot", d),
        *_rope_nodes("kpe", "k_rot", d),
        w.node("Concat", ["q_nope", "q_rot"], ["qh"], name="qh", axis=1),
        w.node("Concat", ["k_nope", "k_rot"], ["kh"], name="kh", axis=1),
        w.node("Transpose", ["kh"], ["kt"], name="kt", perm=[1, 0]),
        w.node("MatMul", ["qh", "kt"], ["scores"], name="scores"),
        w.node("Add", ["scores", "mask"], ["masked"], name="masked"),
        w.node("Softmax", ["masked"], ["p"], name="softmax", axis=-1),
        w.node("MatMul", ["p", "v"], ["o"], name="pv"),
        w.node("MatMul", ["o", "wo"], ["y"], name="o_proj"),
    ]
    cos, sin = rope_tables(cfg)
    init = dict(weights)
    init.update({
        "eps": np.asarray([cfg["rms_norm_eps"]], np.float32),
        "rope_cos": cos, "rope_sin": sin, "mask": causal_mask(cfg),
        "shape_pairs": np.asarray([S, R // 2, 2], np.int64),
        "shape_rope": np.asarray([S, R], np.int64),
    })
    return w.model(nodes, {"x": (S, H + L + R)}, {"y": (S, H)}, init)


# ---------------------------------------------------------------------------
# the plain fixed-point forward
# ---------------------------------------------------------------------------

def _table(fn, v: np.ndarray, in_scale: int, out_scale: int) -> np.ndarray:
    """A lookup table's value: round(fn(v / 2^in) * 2^out), ties to even."""
    with np.errstate(all="ignore"):
        return quantize(fn(np.asarray(v, np.float64) / float(1 << in_scale)), out_scale)


def _recip(v):
    return np.where(v == 0, 0.0, 1.0 / v)


def forward(cfg: dict, weights: dict, x: np.ndarray, input_scale: int,
            param_scale: int) -> np.ndarray:
    """The quantized outputs at scale `input_scale` (int64, flat).

    Each product adds its operands' scales and is brought back to
    `input_scale` by a rounded division by a power of two; an Add first
    lifts the operand of lower scale by a power of two; a nonlinearity is
    its table's value; the mean divides by the row length, rounded; the
    softmax is exp's table, the row sum, a reciprocal table at twice the
    input scale, their product and a rounded division back."""
    si, sp = input_scale, param_scale
    d = widths(cfg)
    S, H, L, N, R = d["S"], d["H"], d["L"], d["N"], d["R"]

    def rebase(v, s):
        return (rounded_div(v, 1 << (s - si)), si) if s > si else (v, s)

    def add(a, sa, b, sb):
        s = max(sa, sb)
        return (a << (s - sa)) + (b << (s - sb)), s

    def rope(t):
        dd = t.reshape(S, R // 2, 2).transpose(0, 2, 1).reshape(S, R)
        rot = np.concatenate([-dd[:, R // 2:], dd[:, :R // 2]], axis=1)
        a, sa = rebase(dd * cosq, si + sp)
        b, sb = rebase(rot * sinq, si + sp)
        return add(a, sa, b, sb)

    xq = quantize(x, si).reshape(S, -1)
    h, ckv, kpe = xq[:, :H], xq[:, H:H + L], xq[:, H + L:H + L + R]
    wq = quantize(weights["wq"], sp)
    wkvb = quantize(weights["wkvb"], sp)
    wo = quantize(weights["wo"], sp)
    gamma = quantize(weights["gamma"], sp)
    cos, sin = rope_tables(cfg)
    cosq, sinq = quantize(cos, sp), quantize(sin, sp)
    eps = quantize(np.float32(cfg["rms_norm_eps"]), sp)
    mask = quantize(causal_mask(cfg), sp)

    q, _ = rebase(h @ wq, si + sp)
    sq, s_sq = rebase(ckv * ckv, 2 * si)
    ms = rounded_div(sq.sum(axis=1, keepdims=True), L)
    mse, s_mse = add(ms, s_sq, eps, sp)
    rms = _table(lambda v: np.sqrt(np.maximum(v, 0)), mse, s_mse, si)
    inv = _table(_recip, rms, si, si)
    cn, s_cn = rebase(ckv * inv, 2 * si)
    c, s_c = rebase(cn * gamma, s_cn + sp)
    kv, _ = rebase(c @ wkvb, s_c + sp)
    q_rot, _ = rope(q[:, N:])
    k_rot, _ = rope(kpe)
    qh = np.concatenate([q[:, :N], q_rot], axis=1)
    kh = np.concatenate([kv[:, :N], k_rot], axis=1)
    scores, s_scores = rebase(qh @ kh.T, 2 * si)
    masked, s_m = add(scores, s_scores, mask, sp)
    ex = _table(np.exp, masked, s_m, si)
    den = ex.sum(axis=1, keepdims=True)
    rden = _table(_recip, den, si, 2 * si)
    p = rounded_div(ex * rden, 1 << (2 * si))
    o, _ = rebase(p @ kv[:, N:], 2 * si)
    y, _ = rebase(o @ wo, si + sp)
    return y.reshape(-1)

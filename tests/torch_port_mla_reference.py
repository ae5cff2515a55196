"""Plain PyTorch references of a DeepSeek-V3-style latent attention (MLA)
layer with no q LoRA, for `tests/test_torch_mla_head.py`. Imports neither
package of this repo, JAX nor a kernel of the port.

Shapes follow DeepSeek-V3's modeling code (`DeepseekV3Attention.forward`):
per head h of `heads`, `q_proj` gives `[q_nope N | q_pe R]`, `kv_b_proj`
gives `[k_nope N | v V]` from the latent `c_kv` (L) after `kv_a_layernorm`,
and `o_proj` maps the heads' `V`-wide outputs to the hidden size H. One
`k_pe` (R) is shared by all heads. RoPE de-interleaves the rope dims, then
rotates halves (`rotate_half`), with `inv_freq = theta^(-2i/R)`.

* `layer_float`: the whole layer as one block, float32, the softmax scale
  `1/sqrt(N + R)` applied to the scores.
* `head_float`: one head's share of the layer's output, float32, with the
  head's weight slices (`head_weights`), the scale folded into W_q.
* `head_fixed`: the same head in int64 fixed point, rounding as a circuit of
  ezkl's kind does, step by step (see its docstring).

The input of a layer or head is (S, H + L + R) = `[h | c_kv | k_pe]`: the
RMS-normed hidden state and the raw output of `kv_a_proj_with_mqa`, positions
0..S-1 with a causal mask and no earlier cache.
"""

from __future__ import annotations

import torch

# a matmul in TF32 on a GPU would not be float32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rope_tables(S: int, R: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (S, R) float32 of positions 0..S-1, built in float64 as the
    benchmark's model file builds the ONNX constants, then rounded."""
    inv = 1.0 / (theta ** (torch.arange(0, R, 2, dtype=torch.float64) / R))
    freqs = torch.outer(torch.arange(S, dtype=torch.float64), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().float(), emb.sin().float()


def _deinterleave(t: torch.Tensor) -> torch.Tensor:
    """(..., R) pairs (x0, x1), (x2, x3), ... -> (x0, x2, ..., x1, x3, ...)."""
    *lead, r = t.shape
    return t.reshape(*lead, r // 2, 2).transpose(-1, -2).reshape(*lead, r)


def _rotate_half(t: torch.Tensor) -> torch.Tensor:
    half = t.shape[-1] // 2
    return torch.cat([-t[..., half:], t[..., :half]], dim=-1)


def _rope(t, cos, sin):
    t = _deinterleave(t)
    return t * cos + _rotate_half(t) * sin


def _rms_norm(c, gamma, eps):
    return c * torch.rsqrt(c.pow(2).mean(-1, keepdim=True) + eps) * gamma


def _causal(scores, mask_value):
    S = scores.shape[-1]
    upper = torch.ones(S, S, dtype=torch.bool).triu(1)
    return scores.masked_fill(upper, mask_value)


def layer_float(x, q_proj, kv_b_proj, o_proj, gamma, dims: dict) -> torch.Tensor:
    """The layer's attention output (S, H), all heads in one block.

    q_proj (heads*(N+R), H), kv_b_proj (heads*(N+V), L), o_proj (H, heads*V)
    are nn.Linear weights (out, in); gamma (L,)."""
    S, H, L, N, R, V = (dims[k] for k in "SHLNRV")
    heads = q_proj.shape[0] // (N + R)
    x = x.float()
    h, c_kv, k_pe = x[:, :H], x[:, H:H + L], x[:, H + L:H + L + R]
    q = (h @ q_proj.T).view(S, heads, N + R).transpose(0, 1)             # (heads, S, N+R)
    q_nope, q_pe = q[..., :N], q[..., N:]
    kv = (_rms_norm(c_kv, gamma, dims["eps"]) @ kv_b_proj.T).view(S, heads, N + V)
    kv = kv.transpose(0, 1)
    k_nope, v = kv[..., :N], kv[..., N:]
    cos, sin = rope_tables(S, R, dims["theta"])
    q_pe = _rope(q_pe, cos, sin)
    k_pe = _rope(k_pe, cos, sin).expand(heads, S, R)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe], dim=-1)
    scores = qs @ ks.transpose(-1, -2) * (N + R) ** -0.5
    p = torch.softmax(_causal(scores, float("-inf")), dim=-1)
    o = (p @ v).transpose(0, 1).reshape(S, heads * V)
    return o @ o_proj.T


def head_weights(q_proj, kv_b_proj, o_proj, gamma, head: int, dims: dict) -> dict:
    """Head `head`'s slices as the head's graph holds them: wq (H, N+R) with
    the softmax scale folded in, wkvb (L, N+V), wo (V, H), gamma (L,)."""
    N, R, V = dims["N"], dims["R"], dims["V"]
    D = N + R
    return {
        "wq": (q_proj[head * D:(head + 1) * D].T * (D ** -0.5)).contiguous(),
        "wkvb": kv_b_proj[head * (N + V):(head + 1) * (N + V)].T.contiguous(),
        "wo": o_proj[:, head * V:(head + 1) * V].T.contiguous(),
        "gamma": gamma.clone(),
    }


def head_float(x, w: dict, dims: dict, mask_value=float("-inf")) -> torch.Tensor:
    """One head's share (S, H) of the layer's output, float32."""
    S, H, L, N, R = (dims[k] for k in "SHLNR")
    x = x.float()
    h, c_kv, k_pe = x[:, :H], x[:, H:H + L], x[:, H + L:H + L + R]
    q = h @ w["wq"]
    kv = _rms_norm(c_kv, w["gamma"], dims["eps"]) @ w["wkvb"]
    cos, sin = rope_tables(S, R, dims["theta"])
    qs = torch.cat([q[:, :N], _rope(q[:, N:], cos, sin)], dim=-1)
    ks = torch.cat([kv[:, :N], _rope(k_pe, cos, sin)], dim=-1)
    p = torch.softmax(_causal(qs @ ks.T, mask_value), dim=-1)
    return (p @ kv[:, N:]) @ w["wo"]


def head_fixed(x, w: dict, dims: dict, input_scale: int, param_scale: int) -> torch.Tensor:
    """One head's share in int64 fixed point; returns (S, H) int64 at scale
    `input_scale`.

    A value v at scale s stands for v / 2^s. As the circuit computes:
    * quantize: inputs at `input_scale`, weights and constants (gamma, eps,
      cos, sin, the mask) at `param_scale`, as round(a * 2^s) of the value
      (float64 inputs, float32 weights and constants), ties to even;
    * a product (elementwise or matmul) is exact and adds its operands'
      scales; a result above `input_scale` is rebased to it by a rounded
      division by 2^(s - input_scale), ties to even;
    * an addition first lifts the operand of lower scale by 2^(difference);
    * the mean divides the row sum by the row length, rounded;
    * a nonlinearity is its table's value round(f(v / 2^s_in) * 2^s_out):
      Sqrt and Reciprocal out at `input_scale`, exp out at `input_scale`,
      the softmax's reciprocal of the row sum out at 2 * `input_scale`
      (1/0 reads 0);
    * the softmax multiplies exp by that reciprocal (scale 3 * input_scale)
      and divides by 2^(2 * input_scale), rounded;
    * the mask is added (its value at `dims["mask"]`), so a masked exp reads
      exactly 0 once exp(mask) * 2^input_scale rounds to 0.
    """
    si, sp = input_scale, param_scale
    S, H, L, N, R = (dims[k] for k in "SHLNR")
    f64 = torch.float64

    def quant(a, s):
        return torch.round(torch.as_tensor(a).to(f64) * 2.0 ** s).to(torch.int64)

    def rdiv(v, d):
        assert int(v.abs().max()) < 1 << 53
        return torch.round(v.to(f64) / d).to(torch.int64)

    def rebase(v, s):
        return (rdiv(v, 2 ** (s - si)), si) if s > si else (v, s)

    def add(a, sa, b, sb):
        s = max(sa, sb)
        return a * 2 ** (s - sa) + b * 2 ** (s - sb), s

    def table(fn, v, s_in, s_out):
        return torch.round(fn(v.to(f64) / 2.0 ** s_in) * 2.0 ** s_out).to(torch.int64)

    def recip(v):
        return torch.where(v == 0, torch.zeros_like(v), 1.0 / v)

    cos, sin = rope_tables(S, R, dims["theta"])
    cosq, sinq = quant(cos, sp), quant(sin, sp)

    def rope(t):
        t = _deinterleave(t)
        a, sa = rebase(t * cosq, si + sp)
        b, sb = rebase(_rotate_half(t) * sinq, si + sp)
        return add(a, sa, b, sb)[0]

    xq = quant(x, si)
    h, c_kv, k_pe = xq[:, :H], xq[:, H:H + L], xq[:, H + L:H + L + R]
    wq, wkvb, wo, gamma = (quant(w[k], sp) for k in ("wq", "wkvb", "wo", "gamma"))

    q, _ = rebase(h @ wq, si + sp)
    sq, s_sq = rebase(c_kv * c_kv, 2 * si)
    ms = rdiv(sq.sum(-1, keepdim=True), L)
    mse, s_mse = add(ms, s_sq, quant(torch.tensor([dims["eps"]]), sp), sp)
    rms = table(lambda v: v.clamp(min=0).sqrt(), mse, s_mse, si)
    inv = table(recip, rms, si, si)
    cn, s_cn = rebase(c_kv * inv, 2 * si)
    c, s_c = rebase(cn * gamma, s_cn + sp)
    kv, _ = rebase(c @ wkvb, s_c + sp)
    qs = torch.cat([q[:, :N], rope(q[:, N:])], dim=-1)
    ks = torch.cat([kv[:, :N], rope(k_pe)], dim=-1)
    scores, s_scores = rebase(qs @ ks.T, 2 * si)
    mask = quant(torch.full((S, S), float(dims["mask"])).triu(1), sp)
    masked, s_m = add(scores, s_scores, mask, sp)
    ex = table(torch.exp, masked, s_m, si)
    rden = table(recip, ex.sum(-1, keepdim=True), si, 2 * si)
    p = rdiv(ex * rden, 2 ** (2 * si))
    o, _ = rebase(p @ kv[:, N:], 2 * si)
    y, _ = rebase(o @ wo, si + sp)
    return y


def dims_of(cfg: dict) -> dict:
    """The widths of a benchmark-style configuration dict."""
    return {"S": cfg["input_shape"][0], "H": cfg["hidden_size"], "L": cfg["kv_lora_rank"],
            "N": cfg["qk_nope_head_dim"], "R": cfg["qk_rope_head_dim"],
            "V": cfg["v_head_dim"], "theta": float(cfg["rope_theta"]),
            "eps": cfg["rms_norm_eps"], "mask": cfg["mask_value"]}


def draw_layer(dims: dict, heads: int, seed: int, std: dict) -> tuple:
    """Seeded float32 weights of a whole layer: q_proj, kv_b_proj, o_proj
    (nn.Linear layout) and gamma."""
    g = torch.Generator().manual_seed(seed)
    H, L, N, R, V = (dims[k] for k in "HLNRV")

    def normal(shape, s):
        return torch.randn(shape, generator=g, dtype=torch.float64).mul(s).float()

    return (normal((heads * (N + R), H), std["q"]), normal((heads * (N + V), L), std["kv_b"]),
            normal((H, heads * V), std["o"]),
            (0.75 + 0.5 * torch.rand(L, generator=g, dtype=torch.float64)).float())

"""The small ONNX models that the port's graph and API tests run.

Each model is built with an `onnx_writer` module passed in (the JAX
package's or the port's), so the tests can hold the two writers' bytes equal
and feed either package the same file. Every builder draws its weights and
its input from its own `numpy.random.default_rng` seed.

`MODELS[name]` is `(build, run_args)`: `build(writer)` returns
`(onnx_bytes, input_json_dict)`, and `run_args` holds the RunArgs fields that
differ from the defaults. mlp_4d settles on k = 8 and the other three on
k = 9, so the JAX prover compiles for two domain sizes when the fixtures are
frozen (`tools/make_torch_fixtures.py --part graph`). The run arguments
follow the tiny-model recipe: small scales, `decomp_base=32` and a narrow
`lookup_range`, whose 513-row ReLU table is larger than the usable rows at
k = 8 and 9 (249 and 505), so it splits into column sets (chunks).
"""

from __future__ import annotations

import json
import pathlib
from functools import partial
from typing import Callable, NamedTuple

import numpy as np

# the graded mlp_4d of `examples/gen_graded.py`, which `chip_smoke.py`'s
# graph phase proves on the card
from chip_smoke import mlp_4d, mlp_4d_draws  # noqa: F401

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"

_SMALL = {
    "input_scale": 2,
    "param_scale": 2,
    "lookup_range": (-256, 256),
    "decomp_base": 32,
}


def _input(x) -> dict:
    return {"input_data": [np.asarray(x, np.float64).reshape(-1).tolist()]}


def conv_small(w):
    """conv -> relu -> average pool -> flatten -> gemm, the op list of the
    graded `conv2d_mnist`, on a 1x1x8x8 input."""
    rng = np.random.default_rng(7)
    k = rng.uniform(-0.5, 0.5, (1, 1, 3, 3)).astype(np.float32)
    kb = rng.uniform(-0.25, 0.25, (1,)).astype(np.float32)
    # 8x8 -> conv 3x3 stride 2 -> 3x3 -> pool 2x2 stride 1 -> 2x2 -> 4
    fcw = rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32)
    fcb = rng.uniform(-0.25, 0.25, (3,)).astype(np.float32)
    nodes = [
        w.node("Conv", ["x", "k", "kb"], ["c0"], name="conv",
               kernel_shape=[3, 3], strides=[2, 2], pads=[0, 0, 0, 0]),
        w.node("Relu", ["c0"], ["a0"], name="relu0"),
        w.node("AveragePool", ["a0"], ["p0"], name="pool",
               kernel_shape=[2, 2], strides=[1, 1]),
        w.node("Flatten", ["p0"], ["f0"], name="flat"),
        w.node("Gemm", ["f0", "fcw", "fcb"], ["y"], name="fc"),
    ]
    onnx = w.model(nodes, {"x": (1, 1, 8, 8)}, {"y": (1, 3)},
                   {"k": k, "kb": kb, "fcw": fcw, "fcb": fcb})
    x = rng.integers(0, 4, (1, 1, 8, 8)).astype(np.float64)
    return onnx, _input(x)


def gemm_freivalds(w):
    """A 4x9 @ 9x16 MatMul, then Relu: M*N*K = 576 > 2*(K*N + M*N + M*K) =
    488 and > 512, so the layout proves the product with Freivalds' check
    and a second-phase advice column (`graph/model.py`, `_matmul`)."""
    rng = np.random.default_rng(11)
    b = rng.uniform(-1, 1, (9, 16)).astype(np.float32)
    nodes = [w.node("MatMul", ["x", "b"], ["h"], name="mm"),
             w.node("Relu", ["h"], ["y"], name="relu")]
    onnx = w.model(nodes, {"x": (4, 9)}, {"y": (4, 16)}, {"b": b})
    x = rng.uniform(-1, 1, (4, 9)).astype(np.float64)
    return onnx, _input(x)


# -- recurrent cells (`tests/test_recurrent.py`), bidirectional --------------

# gates a direction stacks in W (D, G*H, I), R (D, G*H, H), B (D, 2*G*H):
# ONNX orders them i, o, f, c (LSTM), z, r, h (GRU), and one for RNN
_GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


def _recurrent_draws(kind, inputs, hidden, steps, seed):
    """W, R, B (float32, `tests/test_recurrent.py`'s `_onnx_of` layout) and
    the (steps, 1, inputs) input, uniform in +-1/sqrt(hidden) as torch.nn
    draws them."""
    rng = np.random.default_rng(seed)
    g, bound = _GATES[kind], 1.0 / np.sqrt(hidden)
    W = rng.uniform(-bound, bound, (2, g * hidden, inputs)).astype(np.float32)
    R = rng.uniform(-bound, bound, (2, g * hidden, hidden)).astype(np.float32)
    B = rng.uniform(-bound, bound, (2, 2 * g * hidden)).astype(np.float32)
    x = rng.normal(0.0, 0.5, (steps, 1, inputs))
    return W, R, B, x


def recurrent(w, kind, inputs, hidden, steps, seed):
    """One bidirectional ONNX `kind` node (LSTM, GRU with
    linear_before_reset=1, RNN with tanh) on a (steps, 1, inputs) input;
    the output Y is (steps, 2, 1, hidden)."""
    W, R, B, x = _recurrent_draws(kind, inputs, hidden, steps, seed)
    attrs = dict(hidden_size=hidden, direction=b"bidirectional")
    if kind == "GRU":
        attrs["linear_before_reset"] = 1
    nodes = [w.node(kind, ["x", "W", "R", "B"], ["y", "yh"], name=kind.lower(), **attrs)]
    onnx = w.model(nodes, {"x": (steps, 1, inputs)}, {"y": (steps, 2, 1, hidden)},
                   {"W": W, "R": R, "B": B})
    return onnx, _input(x)


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def recurrent_float(kind, inputs, hidden, steps, seed):
    """The float64 forward of `recurrent` with the same arguments, by the
    ONNX definitions of the cells: Y as (steps, 2, 1, hidden)."""
    W, R, B, x = (np.asarray(a, np.float64)
                  for a in _recurrent_draws(kind, inputs, hidden, steps, seed))
    g, H = _GATES[kind], hidden
    y = np.zeros((steps, 2, 1, H))
    for d, order in enumerate((range(steps), range(steps - 1, -1, -1))):
        wb, rb = B[d, :g * H], B[d, g * H:]
        h, c = np.zeros(H), np.zeros(H)
        for t in order:
            gx = W[d] @ x[t, 0] + wb
            gh = R[d] @ h + rb
            if kind == "RNN":
                h = np.tanh(gx + gh)
            elif kind == "GRU":
                z = _sigmoid(gx[:H] + gh[:H])
                r = _sigmoid(gx[H:2 * H] + gh[H:2 * H])
                hh = np.tanh(gx[2 * H:] + r * gh[2 * H:])
                h = (1.0 - z) * hh + z * h
            else:
                a = gx + gh
                i, o, f = _sigmoid(a[:H]), _sigmoid(a[H:2 * H]), _sigmoid(a[2 * H:3 * H])
                c = f * c + i * np.tanh(a[3 * H:])
                h = o * np.tanh(c)
            y[t, d, 0] = h
    return y


# -- a self-attention block -------------------------------------------------

def _attention_draws(seq, width, seed):
    """The initializers (float32; 1/sqrt(width) folded into wq) and the
    (seq, width) input."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(width)
    d = {name: rng.uniform(-bound, bound, (width, width)).astype(np.float32)
         for name in ("wq", "wk", "wv")}
    d["gamma"] = rng.uniform(0.5, 1.5, (width,)).astype(np.float32)
    d["beta"] = rng.uniform(-0.25, 0.25, (width,)).astype(np.float32)
    d["wq"] = d["wq"] / np.float32(np.sqrt(width))
    return d, rng.normal(0.0, 0.5, (seq, width))


def attention(w, seq, width, seed):
    """Single-head self-attention on a (seq, width) input: q, k, v = x Wq,
    x Wk, x Wv; p = Softmax(q k^T) (1/sqrt(width) folded into Wq); y =
    LayerNormalization(p v + x) (epsilon 1e-5, the default). q k^T and
    p v multiply two witness tensors."""
    d, x = _attention_draws(seq, width, seed)
    nodes = [
        w.node("MatMul", ["x", "wq"], ["q"], name="q"),
        w.node("MatMul", ["x", "wk"], ["k"], name="k"),
        w.node("MatMul", ["x", "wv"], ["v"], name="v"),
        w.node("Transpose", ["k"], ["kt"], name="kt", perm=[1, 0]),
        w.node("MatMul", ["q", "kt"], ["s"], name="scores"),
        w.node("Softmax", ["s"], ["p"], name="softmax", axis=-1),
        w.node("MatMul", ["p", "v"], ["o"], name="mix"),
        w.node("Add", ["o", "x"], ["r"], name="residual"),
        w.node("LayerNormalization", ["r", "gamma", "beta"], ["y"], name="norm", axis=-1),
    ]
    onnx = w.model(nodes, {"x": (seq, width)}, {"y": (seq, width)}, d)
    return onnx, _input(x)


def attention_float(seq, width, seed):
    """The float64 forward of `attention` with the same arguments."""
    d, x = _attention_draws(seq, width, seed)
    d = {k: np.asarray(v, np.float64) for k, v in d.items()}
    s = (x @ d["wq"]) @ (x @ d["wk"]).T
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    r = p @ (x @ d["wv"]) + x
    mu = r.mean(axis=-1, keepdims=True)
    var = ((r - mu) ** 2).mean(axis=-1, keepdims=True)
    return (r - mu) / np.sqrt(var + 1e-5) * d["gamma"] + d["beta"]


def bmm_einsum(w):
    """`Einsum "bij,bjk->bik"` of two witness tensors at the shapes of
    `tests/test_einsum.py:36`: one batched Freivalds argument."""
    rng = np.random.default_rng(13)
    a = rng.uniform(-1, 1, (2, 8, 9))
    b = rng.uniform(-1, 1, (2, 9, 8))
    nodes = [w.node("Einsum", ["a", "b"], ["y"], name="bmm", equation=b"bij,bjk->bik")]
    onnx = w.model(nodes, {"a": (2, 8, 9), "b": (2, 9, 8)}, {"y": (2, 8, 8)}, {})
    return onnx, {"input_data": [a.reshape(-1).tolist(), b.reshape(-1).tolist()]}


def gather_dyn(w):
    """An embedding lookup at witness indices: i = ArgMax(x, axis=1), y =
    Gather(E, i). The indices carry a span, so the gather is the
    dynamic-lookup argument, whose table (E's rows) is advice."""
    rng = np.random.default_rng(17)
    e = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    nodes = [w.node("ArgMax", ["x"], ["i"], name="argmax", axis=1, keepdims=0),
             w.node("Gather", ["e", "i"], ["y"], name="gather", axis=0)]
    onnx = w.model(nodes, {"x": (4, 4)}, {"y": (4, 4)}, {"e": e})
    x = rng.uniform(-1, 1, (4, 4))
    return onnx, _input(x)


def _mlp_4d_part(w, part, boundary=None):
    """The two parts that `api.split_model(network.onnx, input.json,
    parts=2)` writes for mlp_4d (cut at the one tensor `a0` between relu0
    and l1), node for node: part 0 is l0 + relu0, part 1 is l1 + relu1.
    Part 0's input is mlp_4d's; part 1's is the rescaled output of part 0's
    witness (`boundary`: that witness.json as a dict), so that the two
    committed boundary columns hold the same values."""
    weights, x = mlp_4d_draws()
    if part == 0:
        nodes = [w.node("Gemm", ["x", "w0", "b0"], ["h0"], name="l0"),
                 w.node("Relu", ["h0"], ["a0"], name="relu0")]
        onnx = w.model(nodes, {"x": [1, 4]}, {"a0": [1, 4]},
                       {"w0": weights["w0"], "b0": weights["b0"]})
        return onnx, _input(x)
    nodes = [w.node("Gemm", ["a0", "w1", "b1"], ["h1"], name="l1"),
             w.node("Relu", ["h1"], ["y"], name="relu1")]
    onnx = w.model(nodes, {"a0": [1, 4]}, {"y": [1, 4]},
                   {"w1": weights["w1"], "b1": weights["b1"]})
    inp = None if boundary is None else \
        _input(boundary["pretty_elements"]["rescaled_outputs"][0])
    return onnx, inp


class Model(NamedTuple):
    """`build(writer)` -> (onnx bytes, input.json dict); `run_args`: the
    RunArgs fields that differ from the defaults; `prove`: the port's CPU
    tests key and prove it (and the fixtures hold the JAX package's vk.key
    and seed=1 proof.json); `card_proof`: the fixtures hold the JAX
    package's vk.key and proof.json, which the CPU tests verify and the card
    (`chip_smoke.py`'s families phase) proves byte for byte; `after`: the
    model whose witness.json gives this one its input (`build(writer,
    boundary=<that witness>)`)."""
    build: Callable
    run_args: dict
    prove: bool = False
    card_proof: bool = False
    after: str | None = None


# the recurrent cells, the attention block and the einsum skip the inputs'
# range check on entry (a reference run argument), as conv_small and
# gemm_freivalds do, which keeps them at k = 9-13; gemm_freivalds also
# keeps the product's scale, so that it fits in 2^9 rows; mlp_4d keeps the
# check
_UNCHECKED = dict(_SMALL, ignore_range_check_inputs_outputs=True)

# the card's widths of the recurrent and attention families
# (`chip_smoke.py`'s families phase): the repo's own choice
CARD_RUN_ARGS = {"input_scale": 7, "param_scale": 7, "lookup_range": (-65536, 65536)}
LSTM_CELL = {"kind": "LSTM", "inputs": 4, "hidden": 3, "steps": 5, "seed": 0}
GRU_CELL = {"kind": "GRU", "inputs": 3, "hidden": 4, "steps": 5, "seed": 1}
RNN_CELL = {"kind": "RNN", "inputs": 3, "hidden": 3, "steps": 5, "seed": 2}
# seq 8 and width 9 are the least at which q k^T and p v both take the
# Freivalds route (M*N*K = 576 > 512 and > 2 (M*K + K*N + M*N) = 416)
ATTN_SMALL = {"seq": 8, "width": 9, "seed": 3}
LSTM_CARD = {"kind": "LSTM", "inputs": 16, "hidden": 32, "steps": 8, "seed": 0}
ATTN_CARD = {"seq": 32, "width": 64, "seed": 3}

MODELS = {
    "mlp_4d": Model(mlp_4d, dict(_SMALL), prove=True),
    "conv_small": Model(conv_small, _UNCHECKED, prove=True),
    "gemm_freivalds": Model(gemm_freivalds, dict(_UNCHECKED, scale_rebase_multiplier=2),
                            prove=True),
    # the mlp_4d graph with a Poseidon-hashed input and KZG-committed
    # params: an in-circuit hash module and unblinded columns committed at
    # witness time
    "mlp_4d_hashed": Model(mlp_4d, dict(_SMALL, input_visibility="hashed",
                                        param_visibility="kzgcommit"), prove=True),
    "lstm_bidi": Model(partial(recurrent, **LSTM_CELL), _UNCHECKED, card_proof=True),
    "gru_bidi": Model(partial(recurrent, **GRU_CELL), _UNCHECKED),
    "rnn_bidi": Model(partial(recurrent, **RNN_CELL), _UNCHECKED),
    "attn_small": Model(partial(attention, **ATTN_SMALL), _UNCHECKED),
    "bmm_einsum": Model(bmm_einsum, _UNCHECKED),
    "gather_dyn": Model(gather_dyn, _UNCHECKED, prove=True),
    "mlp_4d_kzg_io": Model(mlp_4d, dict(_SMALL, input_visibility="kzgcommit",
                                        output_visibility="kzgcommit")),
    "mlp_4d_pub_hashed_out": Model(mlp_4d, dict(_SMALL, input_visibility="public",
                                                output_visibility="hashed")),
    "mlp_4d_all_kzg": Model(mlp_4d, dict(_SMALL, input_visibility="kzgcommit",
                                         output_visibility="kzgcommit",
                                         param_visibility="kzgcommit")),
    # proof splitting (`tests/test_proof_split.py`): part 0 commits its
    # output, part 1 its input; equal commitments link the two proofs
    "mlp_4d_split_0": Model(partial(_mlp_4d_part, part=0),
                            dict(_SMALL, output_visibility="kzgcommit"), card_proof=True),
    "mlp_4d_split_1": Model(partial(_mlp_4d_part, part=1),
                            dict(_SMALL, input_visibility="kzgcommit"), card_proof=True,
                            after="mlp_4d_split_0"),
}

# the card's versions of two families: the same constructors at wider widths
CARD_MODELS = {
    "lstm_bidi_h32": Model(partial(recurrent, **LSTM_CARD), dict(CARD_RUN_ARGS)),
    "attn_s32_d64": Model(partial(attention, **ATTN_CARD), dict(CARD_RUN_ARGS)),
}

FLOAT_FORWARDS = {
    "lstm_bidi": partial(recurrent_float, **LSTM_CELL),
    "gru_bidi": partial(recurrent_float, **GRU_CELL),
    "rnn_bidi": partial(recurrent_float, **RNN_CELL),
    "attn_small": partial(attention_float, **ATTN_SMALL),
    "lstm_bidi_h32": partial(recurrent_float, **LSTM_CARD),
    "attn_s32_d64": partial(attention_float, **ATTN_CARD),
}


def gathered_cell(asg, cfg):
    """(row, advice column) of the first value that gather_dyn's Gather
    laid out: the first row where the dynamic lookup's input selector (a
    fixed column) is on."""
    lk, = [lk for lk in cfg.cs.lookups if lk.name.startswith("dyn_gather")]
    (_, out), = lk.inputs
    cols = {q.column.kind: q.column for q in out.queries()}
    return next(r for r in range(asg.n) if asg.get_int(cols["fixed"], r) == 1), cols["advice"]


def build(name: str, writer, witness_dir=None):
    """(onnx bytes, input.json dict) of `name` (of MODELS or CARD_MODELS).
    A model `after` another reads that one's witness.json from
    `witness_dir(<that name>)` (default: its frozen fixture directory)."""
    m = MODELS.get(name) or CARD_MODELS[name]
    if m.after is None:
        return m.build(writer)
    d = witness_dir(m.after) if witness_dir else FIXTURES / f"graph_{m.after}"
    return m.build(writer, boundary=json.loads((pathlib.Path(d) / "witness.json").read_text()))


def run_args(run_args_cls, name: str):
    """The model's RunArgs, built with the given package's class."""
    return run_args_cls(**(MODELS.get(name) or CARD_MODELS[name]).run_args).validate()

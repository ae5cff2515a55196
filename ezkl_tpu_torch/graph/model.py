"""Model: ONNX graph -> quantized circuit ops (the reference's
`Model`/`Node::new`/`new_op_from_onnx` pipeline, `ezkl/src/graph/
{model.rs,node.rs,utilities.rs}` — SURVEY.md §3.1).

Scale algebra follows the reference: inputs at input_scale, params at
param_scale, multiplicative ops add scales, and any result whose scale
exceeds input_scale * scale_rebase_multiplier is rebased down by a
rounding division (RebaseScale, `node.rs:142-290`). Add/sub operands are
aligned by constant multiplication (Rescaled, `node.rs:86-137`).

Port of `ezkl_tpu/graph/model.py` (pure numpy, copied; imports rewired to the
port's modules).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import onnx_parser, ops
from .layout import BaseConfig, LayoutCtx, TVal
from .quantize import quantize
from .run_args import RunArgs

SUPPORTED = {
    "Relu", "Sigmoid", "Tanh", "Exp", "Gemm", "MatMul", "Add", "Sub", "Mul",
    "Reshape", "Flatten", "Identity", "Constant", "Cast", "Softmax",
}


@dataclasses.dataclass
class Model:
    onnx: onnx_parser.OnnxModel
    run_args: RunArgs

    @classmethod
    def load(cls, path, run_args: RunArgs) -> "Model":
        return cls(onnx=onnx_parser.load(path), run_args=run_args.validate())

    # -- shape resolution ---------------------------------------------------

    def input_shapes(self) -> list[tuple]:
        out = []
        for ti in self.onnx.graph.inputs:
            shape = tuple(
                self.run_args.variables.get(d, d) if isinstance(d, str) else int(d)
                for d in ti.shape
            )
            out.append(tuple(int(s) for s in shape))
        return out

    # ONNX TensorProto int/bool dtypes — quantized at scale 0 (the
    # reference's InputType::{Bool,Int}, `circuit/ops/mod.rs:88-142`)
    _INT_ELEM_TYPES = frozenset({2, 3, 4, 5, 6, 7, 9, 12, 13})

    def input_scales(self) -> list[int]:
        return [0 if ti.elem_type in self._INT_ELEM_TYPES
                else self.run_args.input_scale
                for ti in self.onnx.graph.inputs]

    # -- the layout pass (witness gen + constraints in one walk) ------------

    def layout(self, ctx: LayoutCtx, input_arrays: list[np.ndarray]) -> list[TVal]:
        ra = self.run_args
        g = self.onnx.graph
        values: dict[str, TVal] = {}

        # graph inputs: quantize + place in advice (kzgcommit visibility
        # gets a dedicated unblinded column per input tensor)
        ctx._input_tvals = []
        for ti, arr, in_scale in zip(g.inputs, input_arrays, self.input_scales()):
            q = quantize(arr, in_scale)
            tv = TVal(q, in_scale, None)
            if ra.input_visibility == "kzgcommit":
                ctx.stage_polycommit(tv)     # canonical rows [0, size)
            else:
                ctx.materialize(tv, col=ctx.cfg.a0)
            values[ti.name] = tv
            ctx._input_tvals.append(tv)
            # constrain-on-entry (reference Input op,
            # `ezkl/src/circuit/ops/mod.rs:195-262`, gated by
            # RunArgs.ignore_range_check_inputs_outputs like the
            # reference): bool inputs are bound to {0,1}; numeric inputs
            # get a sign/digit decompose claim, so an out-of-range input
            # value can never satisfy the circuit — without this, inputs
            # enter as unconstrained advice
            if not ra.ignore_range_check_inputs_outputs:
                if ti.elem_type == 9:                 # ONNX BOOL
                    ops.range_check(ctx, tv, 0, 1)
                else:
                    ops.decompose(ctx, tv, ra.decomp_base, ra.decomp_legs,
                                  zero_sign_matters=False)

        # initializers: params, quantized at param_scale, lazily placed
        # (fixed visibility); hashed/kzgcommit params are placed in advice
        # up-front — soundness then comes from the public hash / commitment
        # (`ezkl/src/graph/modules.rs:230-287`)
        ctx._param_tvals = []
        for name, arr in g.initializers.items():
            if np.issubdtype(arr.dtype, np.floating):
                values[name] = TVal(quantize(arr, ra.param_scale),
                                    ra.param_scale, None)
                ctx._param_tvals.append(values[name])
            else:
                values[name] = TVal(arr.astype(np.int64), 0, None)
        if ra.param_visibility == "kzgcommit":
            for tv in ctx._param_tvals:
                ctx.stage_polycommit(tv)
        elif ra.param_visibility == "hashed":
            for tv in ctx._param_tvals:
                ctx.materialize(tv, col=ctx.cfg.a0)

        max_scale = ra.input_scale * ra.scale_rebase_multiplier

        def rebase(tv: TVal) -> TVal:
            if tv.scale > max_scale:
                return ops.div_rebase(ctx, tv, tv.scale - ra.input_scale,
                                      ra.lookup_range)
            return tv

        def align(a: TVal, b: TVal):
            """Equalize scales for add/sub by const-multiplying the lower."""
            if a.scale == b.scale:
                return a, b
            if a.scale < b.scale:
                a = ops.const_mul(ctx, a, 1 << (b.scale - a.scale),
                                  b.scale - a.scale)
            else:
                b = ops.const_mul(ctx, b, 1 << (a.scale - b.scale),
                                  a.scale - b.scale)
            return a, b

        for node in g.nodes:
            op = node.op_type
            ins = [values[i] for i in node.inputs if i]
            if op == "Relu":
                out = ops.relu(ctx, ins[0], ra.lookup_range)
            elif op == "Sigmoid":
                out = ops.sigmoid(ctx, ins[0], ra.input_scale, ra.lookup_range)
            elif op == "Tanh":
                out = ops.tanh_op(ctx, ins[0], ra.input_scale, ra.lookup_range)
            elif op == "Exp":
                out = ops.exp_op(ctx, ins[0], ra.input_scale, ra.lookup_range)
            elif op in ("MatMul", "Gemm"):
                a, b = ins[0], ins[1]
                if op == "Gemm" and node.attrs.get("transB"):
                    b = TVal(np.ascontiguousarray(b.ints.T), b.scale, None) \
                        if b.span is None else _transposed(ctx, b)
                out = self._matmul(ctx, a, b)
                if op == "Gemm" and len(ins) > 2:
                    bias = ins[2]
                    if bias.span is None and bias.scale != out.scale:
                        # re-quantize an unplaced constant directly at the
                        # needed scale (reference rescale_const_with_single_use)
                        orig = bias.ints.astype(np.float64) / (1 << bias.scale)
                        bias = TVal(quantize(orig, out.scale), out.scale, None)
                    a2, b2 = align(out, bias)
                    out = ops.pairwise(ctx, "add", a2, b2)
                out = rebase(out)
            elif op in ("Add", "Sub", "Mul"):
                kind = op.lower()
                if kind in ("add", "sub"):
                    a, b = align(ins[0], ins[1])
                    out = ops.pairwise(ctx, kind, a, b)
                else:
                    out = rebase(ops.pairwise(ctx, "mul", ins[0], ins[1]))
            elif op in ("Reshape", "Flatten", "Identity", "Cast"):
                src = ins[0]
                if op == "Reshape":
                    shape_t = values[node.inputs[1]].ints
                    new_shape = _resolve_reshape(src.shape, shape_t)
                elif op == "Flatten":
                    axis = node.attrs.get("axis", 1)
                    lead = int(np.prod(src.shape[:axis], dtype=np.int64)) or 1
                    new_shape = (lead, int(src.ints.size // lead))
                else:
                    new_shape = src.shape
                out = TVal(src.ints.reshape(new_shape), src.scale, src.span)
            elif op == "Constant":
                arr = node.attrs.get("value")
                if np.issubdtype(arr.dtype, np.floating):
                    out = TVal(quantize(arr, ra.param_scale), ra.param_scale, None)
                    # Const-node params follow param_visibility like
                    # initializers (hashed -> advice + hash; kzgcommit ->
                    # dedicated unblinded column)
                    if ra.param_visibility == "kzgcommit":
                        ctx.materialize(out, col=ctx.cfg.polycommit_column())
                        ctx._param_tvals.append(out)
                    elif ra.param_visibility == "hashed":
                        ctx.materialize(out, col=ctx.cfg.a0)
                        ctx._param_tvals.append(out)
                else:
                    out = TVal(arr.astype(np.int64), 0, None)
            elif op == "Softmax":
                axis = node.attrs.get("axis", -1)
                out = _softmax(ctx, ins[0], ra, axis)
            elif op == "Conv":
                out = self._conv(ctx, node, ins, rebase)
            elif op == "ConvTranspose":
                x, w = ins[0], ins[1]
                bias = ins[2] if len(ins) > 2 else None
                if bias is not None and bias.span is None:
                    orig = bias.ints.astype(np.float64) / (1 << bias.scale)
                    bias = TVal(quantize(orig, x.scale + w.scale),
                                x.scale + w.scale, None)
                elif bias is not None and bias.scale != x.scale + w.scale:
                    d = x.scale + w.scale - bias.scale
                    assert d > 0, "deconv bias scale above accumulator scale"
                    bias = ops.const_mul(ctx, bias, 1 << d, d)
                strides = tuple(node.attrs.get("strides", [1, 1]))
                p = node.attrs.get("pads", [0, 0, 0, 0])
                opad = tuple(node.attrs.get("output_padding", [0, 0]))
                out = rebase(ops.deconv2d(
                    ctx, x, w, bias, strides, (p[0], p[1], p[2], p[3]), opad,
                    matmul_fn=self._matmul))
            elif op in ("Resize", "Upsample"):
                src = ins[0]
                if len(ins) > 2 and ins[2].ints.size:      # Resize: scales in
                    scales = ins[2].ints.astype(np.float64)
                    if ins[2].scale:
                        scales = scales / (1 << ins[2].scale)
                elif len(ins) > 1 and ins[1].ints.size:
                    scales = ins[1].ints.astype(np.float64)
                    if ins[1].scale:
                        scales = scales / (1 << ins[1].scale)
                else:
                    scales = np.asarray(node.attrs.get("scales", [1.0] * src.ints.ndim))
                out = ops.resize_nearest(ctx, src, scales.reshape(-1).tolist())
            elif op in ("MaxPool", "AveragePool", "GlobalAveragePool"):
                out = self._pool(ctx, node, ins, rebase)
            elif op == "Concat":
                axis = node.attrs.get("axis", 0)
                # scalar shape arithmetic can leave stray unit dims; squeeze
                # operands down to the common (minimum) rank
                min_nd = min(t.ints.ndim for t in ins)
                fixed = []
                for t in ins:
                    if t.ints.ndim > min_nd:
                        shp = [d for d in t.ints.shape if d != 1]
                        shp = shp + [1] * (min_nd - len(shp))
                        t = TVal(t.ints.reshape(shp or (1,) * min_nd),
                                 t.scale, t.span)
                    fixed.append(t)
                ins = fixed
                scales = {t.scale for t in ins}
                if len(scales) > 1:
                    tgt = max(scales)
                    ins = [t if t.scale == tgt else
                           ops.const_mul(ctx, t, 1 << (tgt - t.scale), tgt - t.scale)
                           for t in ins]
                out = ops.concat(ctx, ins, axis)
            elif op == "Transpose":
                perm = node.attrs.get("perm") or list(range(ins[0].ints.ndim))[::-1]
                out = ops.transpose(ctx, ins[0], perm)
            elif op in ("Unsqueeze", "Squeeze"):
                axes = node.attrs.get("axes")
                if axes is None and len(node.inputs) > 1:
                    axes = values[node.inputs[1]].ints.reshape(-1).tolist()
                src = ins[0]
                shape = list(src.shape)
                if op == "Unsqueeze":
                    for ax in sorted(axes):
                        shape.insert(ax if ax >= 0 else len(shape) + ax + 1, 1)
                else:
                    if axes:
                        for ax in sorted(axes, reverse=True):
                            assert shape[ax] == 1
                            shape.pop(ax)
                    else:
                        shape = [s for s in shape if s != 1]
                out = TVal(src.ints.reshape(shape), src.scale, src.span)
            elif op == "Slice":
                out = self._slice(ctx, node, ins, values)
            elif op == "Pad":
                out = self._pad(ctx, node, ins, values)
            elif op == "Neg":
                neg1 = TVal(np.full(1, -1, np.int64), 0, None)
                out = ops.pairwise(ctx, "mul", ins[0], neg1)
            elif op == "LeakyRelu":
                alpha = node.attrs.get("alpha", 0.01)
                out = ops.lookup_fn(
                    ctx, f"leaky{alpha}", ins[0],
                    lambda x: np.where(x > 0, x, alpha * x),
                    ins[0].scale, ins[0].scale, ra.lookup_range)
            elif op in ("Sqrt", "Erf", "Ln", "Log", "Cos", "Sin", "Rsqrt",
                        "Reciprocal", "HardSwish", "Elu", "Celu", "Gelu",
                        "Softplus", "Softsign", "HardSigmoid", "Selu", "Mish",
                        "Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh",
                        "Asinh", "Acosh", "Atanh"):
                alpha = node.attrs.get("alpha", 1.0)
                fn = {
                    "Tan": np.tan,
                    "Asin": lambda x: np.arcsin(np.clip(x, -1, 1)),
                    "Acos": lambda x: np.arccos(np.clip(x, -1, 1)),
                    "Atan": np.arctan,
                    "Sinh": np.sinh, "Cosh": np.cosh,
                    "Asinh": np.arcsinh,
                    "Acosh": lambda x: np.arccosh(np.maximum(x, 1.0)),
                    "Atanh": lambda x: np.arctanh(np.clip(x, -0.9999, 0.9999)),
                    "Sqrt": lambda x: np.sqrt(np.maximum(x, 0)),
                    "Rsqrt": lambda x: np.where(x > 0, 1.0 / np.sqrt(np.abs(x) + 1e-12), 0.0),
                    "Erf": lambda x: _erf(x),
                    "Ln": np.log, "Log": np.log,
                    "Cos": np.cos, "Sin": np.sin,
                    "Reciprocal": lambda x: np.where(x == 0, 0.0, 1.0 / x),
                    "HardSwish": lambda x: x * np.clip(x / 6 + 0.5, 0, 1),
                    "Elu": lambda x: np.where(x > 0, x, alpha * (np.exp(x) - 1)),
                    "Celu": lambda x: np.maximum(x, 0) + np.minimum(
                        0, alpha * (np.exp(x / alpha) - 1)),
                    "Gelu": lambda x: 0.5 * x * (1 + _erf(x / np.sqrt(2))),
                    "Softplus": lambda x: np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0),
                    "Softsign": lambda x: x / (1 + np.abs(x)),
                    "HardSigmoid": lambda x: np.clip(
                        node.attrs.get("alpha", 0.2) * x + node.attrs.get("beta", 0.5), 0, 1),
                    "Selu": lambda x: 1.0507 * np.where(x > 0, x, 1.67326 * (np.exp(x) - 1)),
                    "Mish": lambda x: x * np.tanh(np.log1p(np.exp(-np.abs(x)) ) + np.maximum(x, 0)),
                }[op]
                # the table's name carries the attributes that fn bakes in,
                # so a table (and its cached values) is never shared by two
                # functions
                tname = op.lower()
                if op in ("Elu", "Celu"):
                    tname += f"{alpha}"
                elif op == "HardSigmoid":
                    tname += (f"{node.attrs.get('alpha', 0.2)}_"
                              f"{node.attrs.get('beta', 0.5)}")
                out = ops.lookup_fn(ctx, tname, ins[0], fn,
                                    ins[0].scale, ra.input_scale, ra.lookup_range)
            elif op == "PRelu":
                # prelu(x) = relu(x) - alpha * relu(-x), per-channel alpha
                x, alpha = ins[0], ins[1]
                pos = ops.relu(ctx, x, ra.lookup_range)
                neg1 = TVal(np.full(1, -1, np.int64), 0, None)
                negx = ops.pairwise(ctx, "mul", x, neg1)
                negpart = ops.relu(ctx, negx, ra.lookup_range)
                a_shaped = TVal(alpha.ints.reshape(
                    (1, -1) + (1,) * (x.ints.ndim - 2)) if alpha.ints.size > 1
                    else alpha.ints, alpha.scale, alpha.span)
                scaled = ops.pairwise(ctx, "mul", negpart, a_shaped)
                scaled = rebase(scaled)
                a2, b2 = align(pos, scaled)
                out = ops.pairwise(ctx, "sub", a2, b2)
            elif op == "Pow":
                expo = ins[1].ints.reshape(-1)
                e = float(expo[0]) / (1 << ins[1].scale) if ins[1].scale else float(expo[0])
                if e == int(e) and e >= 1:
                    out = rebase(ops.pow_int(ctx, ins[0], int(e)))
                else:
                    out = ops.lookup_fn(ctx, f"pow{e}", ins[0],
                                        lambda x: np.sign(x) * np.abs(x) ** e,
                                        ins[0].scale, ra.input_scale, ra.lookup_range)
            elif op == "Div":
                out = self._div(ctx, node, ins, rebase)
            elif op in ("ReduceSum", "ReduceMean"):
                out = self._reduce(ctx, node, ins, values, mean=(op == "ReduceMean"))
            elif op == "Einsum":
                eq = node.attrs.get("equation")
                eq = eq.decode() if isinstance(eq, bytes) else eq
                out = rebase(self._einsum(ctx, eq, *ins[:2]))
            elif op in ("Greater", "Less", "Equal"):
                a, b = align(ins[0], ins[1])
                fn = {"Greater": ops.greater, "Less": ops.less,
                      "Equal": ops.equals}[op]
                out = fn(ctx, a, b, ra.lookup_range,
                         decomp=(ra.decomp_base, ra.decomp_legs))
            elif op == "Where":
                a, b = align(ins[1], ins[2])
                out = ops.iff(ctx, ins[0], a, b)
            elif op in ("And", "Or", "Xor", "Not"):
                out = ops.logical(ctx, op.lower(), ins[0],
                                  ins[1] if len(ins) > 1 else None)
            elif op == "BatchNormalization":
                out = rebase(self._batchnorm(ctx, node, ins, align))
            elif op in ("Floor", "Ceil", "Round"):
                fn = {"Floor": np.floor, "Ceil": np.ceil,
                      "Round": np.rint}[op]
                out = ops.lookup_fn(ctx, op.lower(), ins[0], fn,
                                    ins[0].scale, ins[0].scale, ra.lookup_range)
            elif op == "Sign":
                if ops._fits_table(ins[0].ints, ra.lookup_range):
                    out = ops.lookup_fn(ctx, "sign", ins[0], np.sign,
                                        ins[0].scale, 0, ra.lookup_range)
                else:  # decompose path: range up to decomp_base**decomp_legs
                    out = ops.sign_decomp(ctx, ins[0], ra.decomp_base,
                                          ra.decomp_legs)
            elif op == "Abs":
                if ops._fits_table(ins[0].ints, ra.lookup_range):
                    out = ops.lookup_fn(ctx, "abs", ins[0], np.abs,
                                        ins[0].scale, ins[0].scale,
                                        ra.lookup_range)
                else:
                    out = ops.abs_decomp(ctx, ins[0], ra.decomp_base,
                                         ra.decomp_legs)
            elif op in ("Max", "Min") and len(ins) == 2:
                a, b = align(ins[0], ins[1])
                if op == "Max":
                    out = ops.pairwise_max(ctx, a, b, ra.lookup_range)
                else:
                    # min(a,b) = a - relu(a-b)
                    diff = ops.pairwise(ctx, "sub", a, b)
                    r = ops.relu(ctx, diff, ra.lookup_range)
                    out = ops.pairwise(ctx, "sub", a, r)
            elif op == "Gather":
                data, indices = ins[0], ins[1]
                axis = node.attrs.get("axis", 0) % data.ints.ndim
                if indices.span is not None:
                    out = self._dynamic_gather(ctx, data, indices, axis)
                else:
                    idx_grid = np.take(
                        np.arange(data.ints.size).reshape(data.shape),
                        indices.ints.astype(np.int64), axis=axis)
                    out = ops.reindex(data, idx_grid.reshape(-1), idx_grid.shape)
            elif op == "GatherElements":
                data, indices = ins[0], ins[1]
                axis = node.attrs.get("axis", 0) % data.ints.ndim
                # some exporters omit axis; shapes pin it down (they must
                # agree on every dim except the gather axis)
                diff_dims = [i for i, (a_, b_) in
                             enumerate(zip(data.shape, indices.shape))
                             if a_ != b_]
                if diff_dims and axis not in diff_dims:
                    axis = diff_dims[0]
                if indices.span is None:
                    grid = np.arange(data.ints.size).reshape(data.shape)
                    idx_grid = np.take_along_axis(
                        grid, indices.ints.astype(np.int64), axis=axis)
                    out = ops.reindex(data, idx_grid.reshape(-1), idx_grid.shape)
                else:
                    out = self._gather_elements_dyn(ctx, data, indices, axis)
            elif op == "GatherND":
                out = self._gather_nd_dyn(ctx, ins[0], ins[1],
                                          node.attrs.get("batch_dims", 0))
            elif op == "ScatterElements":
                out = self._scatter_elements_dyn(
                    ctx, ins[0], ins[1], ins[2],
                    node.attrs.get("axis", 0) % ins[0].ints.ndim, align)
            elif op == "ScatterND":
                out = self._scatter_nd_dyn(ctx, ins[0], ins[1], ins[2], align)
            elif op in ("Expand", "Tile"):
                src = ins[0]
                if op == "Expand":
                    tgt = tuple(int(v) for v in ins[1].ints.reshape(-1))
                    tgt = np.broadcast_shapes(src.shape, tgt)
                    idx = ops._broadcast_indices(src.shape, tgt)
                    out = ops.reindex(src, idx, tgt)
                else:
                    reps = tuple(int(v) for v in ins[1].ints.reshape(-1))
                    idx = np.tile(np.arange(src.ints.size).reshape(src.shape), reps)
                    out = ops.reindex(src, idx.reshape(-1), idx.shape)
            elif op == "ReduceMax":
                out = self._reduce_max(ctx, node, ins, values)
            elif op == "Clip":
                lo = float(ins[1].ints.reshape(-1)[0]) / (1 << ins[1].scale) if len(ins) > 1 else node.attrs.get("min", -np.inf)
                hi = float(ins[2].ints.reshape(-1)[0]) / (1 << ins[2].scale) if len(ins) > 2 else node.attrs.get("max", np.inf)
                out = ops.lookup_fn(ctx, f"clip{lo}_{hi}", ins[0],
                                    lambda x: np.clip(x, lo, hi),
                                    ins[0].scale, ins[0].scale, ra.lookup_range)
            elif op == "Trilu":
                upper = node.attrs.get("upper", 1)
                kk = int(ins[1].ints.reshape(-1)[0]) if len(ins) > 1 else 0
                mfn = np.triu if upper else np.tril
                mask = mfn(np.ones(ins[0].shape[-2:], np.int64), kk)
                mask = mask.reshape((1,) * (ins[0].ints.ndim - 2) + mask.shape)
                out = ops.pairwise(ctx, "mul", ins[0], TVal(mask, 0, None))
            elif op == "ReduceMin":
                neg1 = TVal(np.full(1, -1, np.int64), 0, None)
                negged = ops.pairwise(ctx, "mul", ins[0], neg1)
                m = self._reduce_max(ctx, node, [negged], values)
                out = ops.pairwise(ctx, "mul", m, neg1)
            elif op == "ReduceL1":
                av = ops.lookup_fn(ctx, "abs", ins[0], np.abs,
                                   ins[0].scale, ins[0].scale, ra.lookup_range)
                out = self._reduce(ctx, node, [av], values, mean=False)
            elif op == "ReduceL2":
                sq = ops.pairwise(ctx, "mul", ins[0], ins[0])
                s = self._reduce(ctx, node, [sq], values, mean=False)
                out = ops.lookup_fn(ctx, "sqrt", s,
                                    lambda x: np.sqrt(np.maximum(x, 0)),
                                    s.scale, ra.input_scale, ra.lookup_range)
            elif op == "ReduceLogSumExp":
                ex = ops.exp_op(ctx, ins[0], ra.input_scale, ra.lookup_range)
                s = self._reduce(ctx, node, [ex], values, mean=False)
                out = ops.lookup_fn(ctx, "ln", s, np.log,
                                    s.scale, ra.input_scale, ra.lookup_range)
            elif op == "ReduceProd":
                out = self._reduce(ctx, node, [ins[0]], values, mean=False,
                                   prod=True)
                out = rebase(out)
            elif op in ("ArgMax", "ArgMin"):
                out = self._arg_extremum(ctx, node, ins, is_min=(op == "ArgMin"))
            elif op == "Shape":
                shp = np.asarray(ins[0].shape, np.int64)
                st = node.attrs.get("start", 0)
                en = node.attrs.get("end", len(shp))
                out = TVal(shp[st:en], 0, None)
            elif op == "Size":
                out = TVal(np.asarray([ins[0].ints.size], np.int64), 0, None)
            elif op == "ConstantOfShape":
                shp = tuple(int(v) for v in ins[0].ints.reshape(-1))
                val = node.attrs.get("value")
                val = np.asarray(val).reshape(-1)[0] if val is not None else 0.0
                if np.issubdtype(np.asarray(val).dtype, np.floating):
                    out = TVal(quantize(np.full(shp, float(val)), ra.param_scale),
                               ra.param_scale, None)
                else:
                    out = TVal(np.full(shp, int(val), np.int64), 0, None)
            elif op == "Range":
                def _c(tv):
                    v = tv.ints.reshape(-1)[0]
                    return float(v) / (1 << tv.scale) if tv.scale else int(v)
                arr = np.arange(_c(ins[0]), _c(ins[1]), _c(ins[2]))
                if np.issubdtype(arr.dtype, np.floating):
                    out = TVal(quantize(arr, ra.param_scale), ra.param_scale, None)
                else:
                    out = TVal(arr.astype(np.int64), 0, None)
            elif op == "InstanceNormalization":
                out = rebase(self._instancenorm(ctx, node, ins, align))
            elif op == "LayerNormalization":
                out = rebase(self._layernorm(ctx, node, ins, align))
            elif op == "Split":
                src = ins[0]
                axis = node.attrs.get("axis", 0) % src.ints.ndim
                n_out = len(node.outputs)
                if len(ins) > 1 and ins[1].ints.size:
                    sizes = [int(v) for v in ins[1].ints.reshape(-1)]
                elif node.attrs.get("split"):
                    sizes = list(node.attrs["split"])
                else:
                    sizes = [src.shape[axis] // n_out] * n_out
                grid = np.arange(src.ints.size).reshape(src.shape)
                off = 0
                outs = []
                for sz in sizes:
                    sl = [slice(None)] * src.ints.ndim
                    sl[axis] = slice(off, off + sz)
                    idx = grid[tuple(sl)]
                    outs.append(ops.reindex(src, idx.reshape(-1), idx.shape))
                    off += sz
                for oname, otv in zip(node.outputs, outs):
                    if oname:
                        values[oname] = otv
                out = outs[0]
            elif op == "NonZero":
                # data-dependent output shape: only constant inputs fold
                # (tract concretizes these the same way, `model.rs:686-691`)
                if ins[0].span is not None:
                    raise NotImplementedError("NonZero on witness data "
                                              "(dynamic output shape)")
                nz = np.stack(np.nonzero(ins[0].ints))
                out = TVal(nz.astype(np.int64), 0, None)
            elif op == "OneHot":
                out = self._onehot(ctx, node, ins, align)
            elif op == "TopK":
                outs = self._topk(ctx, node, ins)
                for oname, otv in zip(node.outputs, outs):
                    if oname:
                        values[oname] = otv
                out = outs[0]
            elif op in ("RNN", "GRU", "LSTM"):
                outs = self._recurrent(ctx, node, ins, align, rebase)
                for oname, otv in zip(node.outputs, outs):
                    if oname:
                        values[oname] = otv
                out = outs[0]
            else:
                raise NotImplementedError(f"op {op} not yet supported")
            values[node.outputs[0]] = out
            if os.environ.get("EZKL_TPU_DEBUG_NODES"):
                # per-node witness trace (the reference's RegionCtx
                # debug_report analog, `region.rs:242-257`)
                print(f"[node] {op:16s} -> {node.outputs[0][:40]:40s} "
                      f"scale={out.scale} vals={out.ints.reshape(-1)[:6]}")

        outputs = [values[o.name] for o in g.outputs]
        # place any output that is still a bare constant
        for tv in outputs:
            ctx.materialize(tv)
        return outputs

    # -- op helpers ---------------------------------------------------------

    def _matmul(self, ctx, a: TVal, b: TVal) -> TVal:
        """Route matmul to Freivalds (phase-2 RLC) or base-op dots —
        the reference's strategy choice (`chip/einsum/analysis.rs:170-198`)."""
        from .modules import get_freivalds
        from .quantize import check_range

        if a.ints.ndim > 2 or b.ints.ndim > 2:
            return self._batched_matmul(ctx, a, b)
        use_fre = False
        if (not self.run_args.disable_freivalds
                and a.ints.ndim == 2 and b.ints.ndim == 2):
            M, K = a.ints.shape
            N = b.ints.shape[1]
            base_rows = M * N * K
            fre_rows = K * N + M * N + M * K
            use_fre = base_rows > 2 * fre_rows and base_rows > 512
        if not use_fre:
            return ops.matmul(ctx, a, b)
        mod = get_freivalds(ctx.cfg)
        out_ints = check_range(a.ints @ b.ints)
        span = mod.matmul(ctx, a, b, out_ints)
        return TVal(out_ints, a.scale + b.scale, span)

    def _batched_matmul(self, ctx, a: TVal, b: TVal) -> TVal:
        """ND (batched+broadcast) matmul (ONNX MatMul semantics): ONE
        Freivalds bmm argument over the whole batch when the RLC rows win
        (a broadcast operand is staged once — `FreivaldsModule.bmm`), a
        loop of 2D matmuls otherwise."""
        from .modules import get_freivalds
        from .quantize import check_range

        ash, bsh = a.shape, b.shape
        if a.ints.ndim < 2 or b.ints.ndim < 2:
            raise NotImplementedError("1-D matmul operand")
        batch = np.broadcast_shapes(ash[:-2], bsh[:-2])
        M, K = ash[-2], ash[-1]
        N = bsh[-1]
        Bt = int(np.prod(batch, dtype=np.int64)) if batch else 1

        def bview(tv, shape, last2):
            """Flat indices + TVal of the (Bt, *last2) broadcast view."""
            grid = np.arange(tv.ints.size, dtype=np.int64).reshape(shape)
            g = grid.reshape((1,) * (len(batch) + 2 - grid.ndim) + grid.shape)
            g = np.broadcast_to(g, batch + shape[-2:])
            flat = g.reshape(-1)
            return ops.reindex(tv, flat, (Bt,) + last2)

        a_shared = a.ints.size == M * K and Bt > 1
        b_shared = b.ints.size == K * N and Bt > 1
        base_rows = Bt * M * N * K
        fre_rows = ((M * K if a_shared and not b_shared else Bt * M * K)
                    + (K * N if b_shared else Bt * K * N) + Bt * M * N)
        use_fre = (not self.run_args.disable_freivalds
                   and base_rows > 2 * fre_rows and base_rows > 512)
        if not use_fre:
            def sub2d(tv, shape, bi):
                off = len(batch) - (len(shape) - 2)
                oidx = tuple(0 if shape[i] == 1 else bi[off + i]
                             for i in range(len(shape) - 2))
                grid = np.arange(int(np.prod(shape, dtype=np.int64))).reshape(shape)
                sl = grid[oidx]
                return ops.reindex(tv, sl.reshape(-1), sl.shape)

            outs = []
            for bi in np.ndindex(*batch) if batch else [()]:
                sub = self._matmul(ctx, sub2d(a, ash, bi), sub2d(b, bsh, bi))
                outs.append(TVal(sub.ints.reshape(1, M, N), sub.scale,
                                 sub.span))
            out = ops.concat(ctx, outs, 0) if len(outs) > 1 else outs[0]
            return TVal(out.ints.reshape(batch + (M, N)), out.scale, out.span)

        mod = get_freivalds(ctx.cfg)
        scale = a.scale + b.scale
        if a_shared and not b_shared:
            # flip so the shared operand is staged once: C^T = B^T A^T
            bt3 = bview(ops.transpose(ctx, b, tuple(range(b.ints.ndim - 2))
                                      + (b.ints.ndim - 1, b.ints.ndim - 2)),
                        bsh[:-2] + (N, K), (N, K))
            a2 = ops.reindex(a, np.arange(M * K).reshape(M, K).T.reshape(-1),
                             (K, M))
            out_t = check_range(np.matmul(
                bt3.ints, a2.ints[None]).reshape(Bt, N, M))
            span = mod.bmm(ctx, bt3, a2, out_t, shared_b=True)
            ct = TVal(out_t, scale, span)                  # (Bt, N, M)
            out = ops.transpose(ctx, ct, (0, 2, 1))
        elif b_shared:
            a3 = bview(a, ash, (M, K))
            b2 = ops.reindex(b, np.arange(K * N), (K, N))
            out_i = check_range(np.matmul(a3.ints, b2.ints[None]))
            span = mod.bmm(ctx, a3, b2, out_i, shared_b=True)
            out = TVal(out_i, scale, span)
        else:
            a3 = bview(a, ash, (M, K))
            b3 = bview(b, bsh, (K, N))
            out_i = check_range(np.matmul(a3.ints, b3.ints))
            span = mod.bmm(ctx, a3, b3, out_i)
            out = TVal(out_i, scale, span)
        return TVal(out.ints.reshape(batch + (M, N)), out.scale, out.span)

    def _einsum(self, ctx, eq: str, a: TVal, b: TVal | None = None) -> TVal:
        """Route a two-operand einsum to the universal Freivalds argument
        when the RLC row count wins (the reference's strategy analysis,
        `chip/einsum/analysis.rs:170-198`): classify labels into
        batch/m/n/contraction axes, reindex both operands to a batched
        matmul, and lay ONE `bmm` argument (|A|+|B|+|C| rows instead of
        |C|*K). Falls back to base-op accumulation for diagonals,
        outer products, matvecs, and small contractions."""
        from .modules import get_freivalds
        from .quantize import check_range

        eq = eq.replace(" ", "")
        if b is None:
            return ops.einsum(ctx, eq, a)
        lhs, out_t = eq.split("->")
        t0, t1 = lhs.split(",")
        if ("." in eq or len(set(t0)) != len(t0) or len(set(t1)) != len(t1)
                or len(set(out_t)) != len(out_t)
                or any(c not in t0 and c not in t1 for c in out_t)
                or self.run_args.disable_freivalds):
            return ops.einsum(ctx, eq, a, b)
        dims: dict[str, int] = {}
        for term, shape in ((t0, a.shape), (t1, b.shape)):
            if len(term) != len(shape):
                return ops.einsum(ctx, eq, a, b)
            for c, s in zip(term, shape):
                if dims.setdefault(c, int(s)) != int(s):
                    return ops.einsum(ctx, eq, a, b)
        # pre-sum axes appearing in one operand only (base-op runs)
        only_a = [c for c in t0 if c not in t1 and c not in out_t]
        if only_a:
            nt0 = "".join(c for c in t0 if c not in only_a)
            a = ops.einsum(ctx, f"{t0}->{nt0}", a)
            t0 = nt0
        only_b = [c for c in t1 if c not in t0 and c not in out_t]
        if only_b:
            nt1 = "".join(c for c in t1 if c not in only_b)
            b = ops.einsum(ctx, f"{t1}->{nt1}", b)
            t1 = nt1
        batch = [c for c in out_t if c in t0 and c in t1]
        m_ax = [c for c in out_t if c in t0 and c not in t1]
        n_ax = [c for c in out_t if c in t1 and c not in t0]
        k_ax = [c for c in t0 if c in t1 and c not in out_t]

        def sz(axes):
            return int(np.prod([dims[c] for c in axes], dtype=np.int64))

        Bt, M, N, K = sz(batch), sz(m_ax), sz(n_ax), sz(k_ax)
        base_rows = Bt * M * N * K
        fre_rows = a.ints.size + b.ints.size + Bt * M * N
        if not (k_ax and base_rows > 2 * fre_rows and base_rows > 512):
            return ops.einsum(ctx, eq, a, b)

        def to3(tv, term, groups, shape3):
            perm = tuple(term.index(c) for g in groups for c in g)
            tvt = ops.transpose(ctx, tv, perm)
            return TVal(tvt.ints.reshape(shape3), tvt.scale, tvt.span)

        a3 = to3(a, t0, (batch, m_ax, k_ax), (Bt, M, K))
        b3 = to3(b, t1, (batch, k_ax, n_ax), (Bt, K, N))
        out_ints = check_range(np.matmul(a3.ints, b3.ints))
        mod = get_freivalds(ctx.cfg)
        span = mod.bmm(ctx, a3, b3, out_ints)
        cur = batch + m_ax + n_ax
        full = tuple(dims[c] for c in cur)
        c_tv = TVal(out_ints.reshape(full), a.scale + b.scale, span)
        if cur != list(out_t):
            c_tv = ops.transpose(ctx, c_tv,
                                 tuple(cur.index(c) for c in out_t))
        return c_tv

    def _conv(self, ctx, node, ins, rebase):
        ra = self.run_args
        x, w = ins[0], ins[1]
        bias = ins[2] if len(ins) > 2 else None
        groups = node.attrs.get("group", 1)
        dil = tuple(node.attrs.get("dilations", [1, 1]))
        strides = tuple(node.attrs.get("strides", [1, 1]))
        pads = node.attrs.get("pads", [0, 0, 0, 0])
        padding = (pads[0], pads[1], pads[2], pads[3])
        if bias is not None and bias.span is None:
            orig = bias.ints.astype(np.float64) / (1 << bias.scale)
            bias = TVal(quantize(orig, x.scale + w.scale), x.scale + w.scale, None)
        elif bias is not None and bias.scale != x.scale + w.scale:
            # hashed/kzgcommit params are placed (span set) at param_scale
            # before ops run; rebase the committed bias UP in-circuit so the
            # conv add sees matching scales (requantizing would break the
            # public hash/commitment of the raw param values)
            d = x.scale + w.scale - bias.scale
            assert d > 0, f"conv bias scale {bias.scale} above {x.scale + w.scale}"
            bias = ops.const_mul(ctx, bias, 1 << d, d)
        if groups == 1:
            out = ops.conv2d(ctx, x, w, bias, strides, padding,
                             ra.lookup_range, matmul_fn=self._matmul,
                             dilations=dil)
            return rebase(out)
        # grouped conv: per-group channel slices (free reindex), concat on
        # the output-channel axis (reference Conv group handling)
        N, C = x.shape[0], x.shape[1]
        O = w.shape[0]
        cg, og = C // groups, O // groups
        xg_grid = np.arange(x.ints.size).reshape(x.shape)
        wg_grid = np.arange(w.ints.size).reshape(w.shape)
        outs = []
        for gi in range(groups):
            xs = xg_grid[:, gi * cg:(gi + 1) * cg]
            ws = wg_grid[gi * og:(gi + 1) * og]
            xg = ops.reindex(x, xs.reshape(-1), xs.shape)
            wg = ops.reindex(w, ws.reshape(-1), ws.shape)
            bg = None
            if bias is not None:
                bgrid = np.arange(bias.ints.size)
                bs = bgrid[gi * og:(gi + 1) * og]
                bg = ops.reindex(bias, bs, (og,))
            outs.append(ops.conv2d(ctx, xg, wg, bg, strides, padding,
                                   ra.lookup_range, matmul_fn=self._matmul,
                                   dilations=dil))
        return rebase(ops.concat(ctx, outs, 1))

    def _pool(self, ctx, node, ins, rebase):
        ra = self.run_args
        x = ins[0]
        squeeze_w = False
        if node.op_type != "GlobalAveragePool" \
                and len(node.attrs.get("kernel_shape", [1, 1])) == 1:
            # 1-D pool: run as (k, 1) over an added unit width axis
            squeeze_w = True
            x = TVal(x.ints.reshape(x.shape + (1,)), x.scale, x.span)
            k1 = node.attrs["kernel_shape"][0]
            s1 = node.attrs.get("strides", [1])[0]
            p = node.attrs.get("pads", [0, 0])
            kernel, strides = (k1, 1), (s1, 1)
            pads = (p[0], 0, p[-1], 0)
        elif node.op_type == "GlobalAveragePool":
            if x.ints.ndim == 3:
                squeeze_w = True
                x = TVal(x.ints.reshape(x.shape + (1,)), x.scale, x.span)
            kernel = (x.shape[2], x.shape[3])
            strides = (1, 1)
            pads = (0, 0, 0, 0)
        else:
            kernel = tuple(node.attrs.get("kernel_shape"))
            strides = tuple(node.attrs.get("strides", [1, 1]))
            p = node.attrs.get("pads", [0, 0, 0, 0])
            pads = (p[0], p[1], p[2], p[3])
        if node.op_type == "MaxPool":
            out = ops.maxpool2d(ctx, x, kernel, strides, pads, ra.lookup_range)
        else:
            s = ops.sumpool2d(ctx, x, kernel, strides, pads)
            area = kernel[0] * kernel[1]
            out = ops.div_known(ctx, s, area, s.scale)
        if squeeze_w:
            out = TVal(out.ints.reshape(out.ints.shape[:-1]), out.scale,
                       out.span)
        return out

    def _slice(self, ctx, node, ins, values):
        src = ins[0]
        if len(node.inputs) > 1:
            starts = values[node.inputs[1]].ints.reshape(-1).tolist()
            ends = values[node.inputs[2]].ints.reshape(-1).tolist()
            axes = (values[node.inputs[3]].ints.reshape(-1).tolist()
                    if len(node.inputs) > 3 else list(range(len(starts))))
            steps = (values[node.inputs[4]].ints.reshape(-1).tolist()
                     if len(node.inputs) > 4 else [1] * len(starts))
        else:
            starts = node.attrs.get("starts")
            ends = node.attrs.get("ends")
            axes = node.attrs.get("axes", list(range(len(starts))))
            steps = [1] * len(starts)
        slicer = [slice(None)] * src.ints.ndim
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            slicer[ax] = slice(st, None if en >= 2**31 else en, sp)
        idx = np.arange(src.ints.size).reshape(src.shape)[tuple(slicer)]
        return ops.reindex(src, idx.reshape(-1), idx.shape)

    def _pad(self, ctx, node, ins, values):
        src = ins[0]
        if len(node.inputs) > 1:
            p = values[node.inputs[1]].ints.reshape(-1).tolist()
        else:
            p = node.attrs.get("pads")
        nd = src.ints.ndim
        pads = tuple((p[i], p[i + nd]) for i in range(nd))
        return ops.pad(ctx, src, pads)

    def _div(self, ctx, node, ins, rebase):
        ra = self.run_args
        a, b = ins[0], ins[1]
        if b.span is None and b.ints.size == 1:
            # constant divisor d: x/d = x * round(2^s/d) / 2^s — one const
            # mul then a claimed-quotient rebase (no table-range limits)
            d = float(b.ints.reshape(-1)[0]) / (1 << b.scale)
            s = ra.param_scale
            mul_c = TVal(np.asarray([round((1 << s) / d)], np.int64), s, None)
            prod = ops.pairwise(ctx, "mul", a, mul_c)
            return ops.div_rebase(ctx, prod, prod.scale - a.scale)
        inv = ops.lookup_fn(ctx, "recip", b,
                            lambda x: np.where(x == 0, 0.0, 1.0 / x),
                            b.scale, 2 * ra.input_scale, ra.lookup_range)
        return rebase(ops.pairwise(ctx, "mul", a, inv))

    def _reduce(self, ctx, node, ins, values, mean: bool, prod: bool = False):
        ra = self.run_args
        src = ins[0]
        axes = node.attrs.get("axes")
        if axes is None and len(node.inputs) > 1:
            axes = values[node.inputs[1]].ints.reshape(-1).tolist()
        if axes is None:
            axes = list(range(src.ints.ndim))
        axes = [a % src.ints.ndim for a in axes]
        keep = [i for i in range(src.ints.ndim) if i not in axes]
        perm = keep + axes
        moved = ops.transpose(ctx, src, perm)
        out_shape = tuple(src.shape[i] for i in keep)
        runs = int(np.prod(out_shape, dtype=np.int64)) or 1
        rl = int(moved.ints.size // runs)
        flat = TVal(moved.ints.reshape(runs, rl), moved.scale, moved.span)
        if prod:
            out = ops.reindex(flat, np.arange(runs) * rl, (runs,))
            for j in range(1, rl):
                e = ops.reindex(flat, np.arange(runs) * rl + j, (runs,))
                out = ops.pairwise(ctx, "mul", out, e)
        else:
            out = ops.einsum(ctx, "rk->r", flat)
        out = TVal(out.ints.reshape(out_shape), out.scale,
                   out.span)
        if mean:
            out = ops.div_known(ctx, out, rl, out.scale)
        keepdims = node.attrs.get("keepdims", 1)
        if keepdims:
            shp = list(src.shape)
            for a in axes:
                shp[a] = 1
            out = TVal(out.ints.reshape(shp), out.scale, out.span)
        return out

    def _reduce_max(self, ctx, node, ins, values):
        """ReduceMax via iterated pairwise max along the reduced axes."""
        ra = self.run_args
        src = ins[0]
        axes = node.attrs.get("axes")
        if axes is None and len(node.inputs) > 1:
            axes = values[node.inputs[1]].ints.reshape(-1).tolist()
        if axes is None:
            axes = list(range(src.ints.ndim))
        axes = [a % src.ints.ndim for a in axes]
        keep = [i for i in range(src.ints.ndim) if i not in axes]
        perm = keep + axes
        moved = ops.transpose(ctx, src, perm)
        out_shape = tuple(src.shape[i] for i in keep)
        runs = int(np.prod(out_shape, dtype=np.int64)) or 1
        rl = int(moved.ints.size // runs)
        flat = TVal(moved.ints.reshape(runs, rl), moved.scale, moved.span)
        acc = ops.reindex(flat, np.arange(runs) * rl, (runs,))
        for j in range(1, rl):
            elem = ops.reindex(flat, np.arange(runs) * rl + j, (runs,))
            acc = ops.pairwise_max(ctx, acc, elem, ra.lookup_range)
        out = TVal(acc.ints.reshape(out_shape), acc.scale, acc.span)
        if node.attrs.get("keepdims", 1):
            shp = list(src.shape)
            for a in axes:
                shp[a] = 1
            out = TVal(out.ints.reshape(shp), out.scale, out.span)
        return out

    def _arg_extremum(self, ctx, node, ins, is_min: bool):
        """ArgMax/ArgMin: chained pairwise extremum, then a first-occurrence
        indicator (exclusive running product of (1-eq)) dotted with indices
        (the reference's claimed-argmax hybrid, `hybrid.rs:15-106`)."""
        ra = self.run_args
        src = ins[0]
        nd = src.ints.ndim
        axis = node.attrs.get("axis", 0) % nd
        perm = [i for i in range(nd) if i != axis] + [axis]
        moved = ops.transpose(ctx, src, perm)
        rl = src.shape[axis]
        runs = int(src.ints.size // rl) or 1
        flat = TVal(moved.ints.reshape(runs, rl), moved.scale, moved.span)
        elems = [ops.reindex(flat, np.arange(runs) * rl + j, (runs,))
                 for j in range(rl)]
        acc = elems[0]
        for e in elems[1:]:
            if is_min:
                diff = ops.pairwise(ctx, "sub", acc, e)
                r = ops.relu(ctx, diff, ra.lookup_range)
                acc = ops.pairwise(ctx, "sub", acc, r)
            else:
                acc = ops.pairwise_max(ctx, acc, e, ra.lookup_range)
        one = TVal(np.ones(1, np.int64), 0, None)
        prefix = TVal(np.ones(runs, np.int64), 0, None)
        idx = TVal(np.zeros(runs, np.int64), 0, None)
        for j, e in enumerate(elems):
            eq = ops.equals(ctx, e, acc, ra.lookup_range)
            first = ops.pairwise(ctx, "mul", eq, prefix)
            if j:
                jc = TVal(np.full(1, j, np.int64), 0, None)
                idx = ops.pairwise(ctx, "add", idx,
                                   ops.pairwise(ctx, "mul", first, jc))
            if j < rl - 1:
                prefix = ops.pairwise(ctx, "mul", prefix,
                                      ops.pairwise(ctx, "sub", one, eq))
        out_shape = tuple(src.shape[i] for i in range(nd) if i != axis)
        out = TVal(idx.ints.reshape(out_shape or (1,)), 0, idx.span)
        if node.attrs.get("keepdims", 1):
            shp = list(src.shape)
            shp[axis] = 1
            out = TVal(out.ints.reshape(shp), 0, out.span)
        return out

    # -- dynamic (witness-index) gather via the dynamic-lookup argument -----
    # (reference `layouts.rs:1483`, `ops/chip.rs:619-714`): L + 3N rows.
    # Scatter still uses one-hot indicators (needs a mask/uniqueness
    # argument, not just membership).

    def _eq_const(self, ctx, idx: TVal, j: int) -> TVal:
        jc = TVal(np.full(1, j, np.int64), 0, None)
        return ops.equals(ctx, idx, jc, self.run_args.lookup_range)

    def _flat_dynamic_index(self, ctx, indices: TVal, scale_const: int,
                            offsets: np.ndarray) -> TVal:
        """lin = idx * scale_const + offsets as constrained scale-0
        arithmetic; `offsets` may broadcast indices up (pairwise handles
        the span bookkeeping)."""
        lin = (indices if scale_const == 1
               else ops.const_mul(ctx, indices, int(scale_const)))
        if offsets.any() or offsets.shape != lin.ints.shape:
            lin = ops.pairwise(ctx, "add", lin,
                               TVal(np.ascontiguousarray(offsets, np.int64),
                                    0, None))
        return lin

    def _dynamic_gather(self, ctx, data: TVal, indices: TVal, axis: int) -> TVal:
        """Witness-index gather via the dynamic-lookup argument
        (`layouts.rs:1483`): linearize indices, then one logup of
        (lin, out) rows against the (pos, value) advice table. L + 3N rows
        instead of the old one-hot indicator formulation's O(L*N)."""
        assert indices.scale == 0, "gather indices must be integer-typed"
        L = data.shape[axis]
        pre = data.shape[:axis]
        post = data.shape[axis + 1:]
        npre = int(np.prod(pre, dtype=np.int64)) or 1
        npost = int(np.prod(post, dtype=np.int64)) or 1
        K = int(indices.ints.size)
        # output element (ip, k, jp) reads flat data index (ip*L + idx[k])*npost + jp
        out_shape = (npre, K, npost)
        idx_r = TVal(indices.ints.reshape(1, K, 1), 0, indices.span)
        offs = np.ascontiguousarray(np.broadcast_to(
            np.arange(npre).reshape(-1, 1, 1) * (L * npost)
            + np.arange(npost).reshape(1, 1, -1), out_shape))
        lin = self._flat_dynamic_index(ctx, idx_r, npost, offs)
        flat_data = TVal(data.ints.reshape(-1), data.scale, data.span)
        out = ctx.dynamic_lookup_gather(flat_data, lin)
        return TVal(out.ints.reshape(pre + indices.shape + post),
                    out.scale, out.span)

    def _gather_elements_dyn(self, ctx, data: TVal, indices: TVal,
                             axis: int) -> TVal:
        """GatherElements with witness indices: out[i.., k, j..] =
        data[i.., idx[i.., k, j..], j..] — same dynamic-lookup reduction."""
        assert indices.scale == 0
        shp = indices.shape
        grid = np.indices(shp)
        L = data.shape[axis]
        npost = int(np.prod(data.shape[axis + 1:], dtype=np.int64)) or 1
        # flat data index = (pre_index*L + idx)*npost + post_index
        pre_lin = np.zeros(shp, np.int64)
        post_lin = np.zeros(shp, np.int64)
        stride = 1
        for d in range(data.ints.ndim - 1, axis, -1):
            post_lin += grid[d] * stride
            stride *= data.shape[d]
        stride = 1
        for d in range(axis - 1, -1, -1):
            pre_lin += grid[d] * stride
            stride *= data.shape[d]
        offs = pre_lin * (L * npost) + post_lin
        lin = self._flat_dynamic_index(ctx, indices, npost, offs)
        flat_data = TVal(data.ints.reshape(-1), data.scale, data.span)
        out = ctx.dynamic_lookup_gather(flat_data, lin)
        return TVal(out.ints.reshape(shp), out.scale, out.span)

    def _linearize_nd_index(self, ctx, indices: TVal, dims: tuple) -> TVal:
        """Fold the last-dim components of an ND index into a flat index:
        lin = sum_i comp_i * stride_i (scale-0 arithmetic)."""
        d = indices.shape[-1]
        strides = np.cumprod([1] + list(dims[::-1]))[::-1][1:]  # row-major
        grid = np.arange(indices.ints.size).reshape(indices.shape)
        lin = None
        for i in range(d):
            sl = grid[..., i]
            comp = ops.reindex(indices, sl.reshape(-1), sl.shape)
            term = (comp if strides[i] == 1
                    else ops.const_mul(ctx, comp, int(strides[i])))
            lin = term if lin is None else ops.pairwise(ctx, "add", lin, term)
        return lin

    def _gather_nd_dyn(self, ctx, data: TVal, indices: TVal,
                       batch_dims: int) -> TVal:
        if batch_dims:
            raise NotImplementedError("GatherND batch_dims > 0")
        if indices.span is None:
            d = indices.shape[-1]
            lin = indices.ints.reshape(-1, d) @ np.cumprod(
                [1] + list(data.shape[:d][::-1]))[::-1][1:]
            grid = np.arange(data.ints.size).reshape(
                (int(np.prod(data.shape[:d], dtype=np.int64)),) + data.shape[d:])
            sel = grid[lin]
            return ops.reindex(data, sel.reshape(-1),
                               indices.shape[:-1] + data.shape[d:])
        d = indices.shape[-1]
        dims = data.shape[:d]
        L = int(np.prod(dims, dtype=np.int64))
        if L > 4096:
            raise NotImplementedError(f"dynamic GatherND over {L} slices")
        lin = self._linearize_nd_index(ctx, indices, dims)
        flat_data = TVal(data.ints.reshape((L,) + data.shape[d:]),
                         data.scale, data.span)
        out = self._dynamic_gather(ctx, flat_data,
                                   TVal(lin.ints.reshape(indices.shape[:-1]),
                                        0, lin.span), 0)
        return out

    def _scatter_elements_dyn(self, ctx, data: TVal, indices: TVal,
                              updates: TVal, axis: int, align) -> TVal:
        """out = data*(1-mask) + scattered updates, mask/contrib built from
        one-hot indicators over the scatter axis (assumes unique indices per
        slice, as ONNX requires for deterministic ScatterElements)."""
        ra = self.run_args
        L = data.shape[axis]
        if L > 4096:
            raise NotImplementedError(f"dynamic ScatterElements over axis {L}")
        grid_u = np.arange(updates.ints.size).reshape(updates.shape)
        nupd = updates.shape[axis]
        eqs = []   # eqs[k][t]: indicator that idx[..., k]==t
        idx_flat = TVal(indices.ints.reshape(-1), 0, indices.span)
        for k in range(nupd):
            slk = np.take(grid_u, k, axis=axis)
            comp = ops.reindex(indices, slk.reshape(-1), slk.shape) \
                if indices.span is not None else None
            if comp is None:
                comp = TVal(np.take(indices.ints, k, axis=axis), 0, None)
            eqs.append([self._eq_const(ctx, comp, t) for t in range(L)])
        grid_d = np.arange(data.ints.size).reshape(data.shape)
        out_slices = []
        one = TVal(np.ones(1, np.int64), 0, None)
        for t in range(L):
            sld = np.take(grid_d, t, axis=axis)
            dslice = ops.reindex(data, sld.reshape(-1), sld.shape)
            mask = None
            contrib = None
            for k in range(nupd):
                slk = np.take(grid_u, k, axis=axis)
                uslice = ops.reindex(updates, slk.reshape(-1), slk.shape)
                e = eqs[k][t]
                e = TVal(e.ints.reshape(uslice.ints.shape), 0, e.span)
                mask = e if mask is None else ops.pairwise(ctx, "add", mask, e)
                term = ops.pairwise(ctx, "mul", e, uslice)
                contrib = term if contrib is None else \
                    ops.pairwise(ctx, "add", contrib, term)
            keep = ops.pairwise(ctx, "sub", one, mask)
            kept = ops.pairwise(ctx, "mul", keep, dslice)
            a2, b2 = align(kept, contrib)
            o = ops.pairwise(ctx, "add", a2, b2)
            shp = list(o.ints.shape)
            shp.insert(axis, 1)
            out_slices.append(TVal(o.ints.reshape(shp), o.scale, o.span))
        return ops.concat(ctx, out_slices, axis)

    def _scatter_nd_dyn(self, ctx, data: TVal, indices: TVal,
                        updates: TVal, align) -> TVal:
        d = indices.shape[-1]
        dims = data.shape[:d]
        L = int(np.prod(dims, dtype=np.int64))
        if L > 4096:
            raise NotImplementedError(f"dynamic ScatterND over {L} slices")
        lin = self._linearize_nd_index(ctx, indices, dims) \
            if indices.span is not None else \
            TVal(indices.ints.reshape(-1, d) @ np.cumprod(
                [1] + list(dims[::-1]))[::-1][1:], 0, None)
        flat_data = TVal(data.ints.reshape((L,) + data.shape[d:]),
                         data.scale, data.span)
        flat_upd = TVal(
            updates.ints.reshape((-1,) + data.shape[d:]),
            updates.scale, updates.span)
        # indicator scatter over the flattened leading dims
        nupd = flat_upd.ints.shape[0]
        lin_flat = TVal(lin.ints.reshape(-1), 0, lin.span)
        grid_u = np.arange(flat_upd.ints.size).reshape(flat_upd.ints.shape)
        grid_d = np.arange(flat_data.ints.size).reshape(flat_data.ints.shape)
        one = TVal(np.ones(1, np.int64), 0, None)
        rows = []
        eq_cache = [[None] * L for _ in range(nupd)]
        for k in range(nupd):
            comp = ops.reindex(lin_flat, np.asarray([k]), (1,))
            for t in range(L):
                eq_cache[k][t] = self._eq_const(ctx, comp, t)
        for t in range(L):
            dslice = ops.reindex(flat_data, grid_d[t].reshape(-1),
                                 grid_d[t].shape)
            mask = None
            contrib = None
            for k in range(nupd):
                uslice = ops.reindex(flat_upd, grid_u[k].reshape(-1),
                                     grid_u[k].shape)
                e = eq_cache[k][t]
                eb = TVal(e.ints.reshape((1,) * max(dslice.ints.ndim, 1)),
                          0, e.span)
                mask = eb if mask is None else ops.pairwise(ctx, "add", mask, eb)
                term = ops.pairwise(ctx, "mul", eb, uslice)
                contrib = term if contrib is None else \
                    ops.pairwise(ctx, "add", contrib, term)
            keep = ops.pairwise(ctx, "sub", one, mask)
            kept = ops.pairwise(ctx, "mul", keep, dslice)
            a2, b2 = align(kept, contrib)
            o = ops.pairwise(ctx, "add", a2, b2)
            rows.append(TVal(o.ints.reshape((1,) + tuple(o.ints.shape)),
                             o.scale, o.span))
        out = ops.concat(ctx, rows, 0) if len(rows) > 1 else rows[0]
        return TVal(out.ints.reshape(data.shape), out.scale, out.span)

    def _onehot(self, ctx, node, ins, align):
        """OneHot(indices, depth, [off, on]) via the eq-indicator family
        (reference `layouts.rs:1398`)."""
        indices, depth_tv = ins[0], ins[1]
        depth = int(depth_tv.ints.reshape(-1)[0])
        vals = ins[2] if len(ins) > 2 else None
        nd_out = indices.ints.ndim + 1
        axis = node.attrs.get("axis", -1) % nd_out
        flat_idx = TVal(indices.ints.reshape(-1), 0, indices.span)
        cols = []
        for j in range(depth):
            eq = self._eq_const(ctx, flat_idx, j)
            cols.append(TVal(eq.ints.reshape(-1, 1), 0, eq.span))
        hot = ops.concat(ctx, cols, 1)          # (n_idx, depth), {0,1} scale 0
        if vals is not None:
            off_f, on_f = (vals.ints.astype(np.float64)
                           / (1 << vals.scale)).reshape(-1)
            if (off_f, on_f) != (0.0, 1.0):
                span_c = TVal(quantize(np.asarray(on_f - off_f),
                                       vals.scale), vals.scale, None)
                hot = ops.pairwise(ctx, "mul", hot, span_c)
                if off_f:
                    off_c = TVal(quantize(np.asarray(off_f), hot.scale),
                                 hot.scale, None)
                    hot = ops.pairwise(ctx, "add", hot, off_c)
        # (idx..., depth) -> move depth to `axis`
        cur = indices.shape + (depth,)
        hot = TVal(hot.ints.reshape(cur), hot.scale, hot.span)
        perm = list(range(len(indices.shape)))
        perm.insert(axis, len(indices.shape))
        return ops.transpose(ctx, hot, perm)

    def _topk(self, ctx, node, ins):
        """TopK by iterative extraction: max -> first-occurrence one-hot ->
        index, then mask the taken element out (reference's sort/topk
        family, `layouts.rs:1158-1360`)."""
        ra = self.run_args
        src = ins[0]
        kk = int(ins[1].ints.reshape(-1)[0])
        nd = src.ints.ndim
        axis = node.attrs.get("axis", -1) % nd
        largest = node.attrs.get("largest", 1)
        perm = [i for i in range(nd) if i != axis] + [axis]
        moved = ops.transpose(ctx, src, perm)
        rl = src.shape[axis]
        runs = int(src.ints.size // rl) or 1
        cur = TVal(moved.ints.reshape(runs, rl), moved.scale, moved.span)
        one = TVal(np.ones(1, np.int64), 0, None)
        # sentinel just outside the data range (keeps lookup diffs in-table)
        lo = int(cur.ints.min()) - 1
        hi = int(cur.ints.max()) + 1
        sentinel = TVal(np.full(1, lo if largest else hi, np.int64),
                        cur.scale, None)
        val_rows, idx_rows = [], []
        for _ in range(kk):
            elems = [ops.reindex(cur, np.arange(runs) * rl + j, (runs,))
                     for j in range(rl)]
            acc = elems[0]
            for e in elems[1:]:
                if largest:
                    acc = ops.pairwise_max(ctx, acc, e, ra.lookup_range)
                else:
                    diff = ops.pairwise(ctx, "sub", acc, e)
                    r = ops.relu(ctx, diff, ra.lookup_range)
                    acc = ops.pairwise(ctx, "sub", acc, r)
            prefix = TVal(np.ones(runs, np.int64), 0, None)
            idx = TVal(np.zeros(runs, np.int64), 0, None)
            sel_cols = []
            for j, e in enumerate(elems):
                eq = ops.equals(ctx, e, acc, ra.lookup_range)
                first = ops.pairwise(ctx, "mul", eq, prefix)
                sel_cols.append(TVal(first.ints.reshape(-1, 1), 0, first.span))
                if j:
                    jc = TVal(np.full(1, j, np.int64), 0, None)
                    idx = ops.pairwise(ctx, "add", idx,
                                       ops.pairwise(ctx, "mul", first, jc))
                if j < rl - 1:
                    prefix = ops.pairwise(ctx, "mul", prefix,
                                          ops.pairwise(ctx, "sub", one, eq))
            val_rows.append(TVal(acc.ints.reshape(runs, 1), acc.scale, acc.span))
            idx_rows.append(TVal(idx.ints.reshape(runs, 1), 0, idx.span))
            if len(val_rows) < kk:
                sel = ops.concat(ctx, sel_cols, 1)          # (runs, rl)
                notsel = ops.pairwise(ctx, "sub", one, sel)
                kept = ops.pairwise(ctx, "mul", notsel, cur)
                repl = ops.pairwise(ctx, "mul", sel, sentinel)
                cur = ops.pairwise(ctx, "add", kept, repl)
        vals = ops.concat(ctx, val_rows, 1)                  # (runs, k)
        idxs = ops.concat(ctx, idx_rows, 1)
        out_shape = tuple(src.shape[i] for i in perm[:-1]) + (kk,)
        inv_perm = np.argsort(perm).tolist()
        vt = ops.transpose(ctx, TVal(vals.ints.reshape(out_shape),
                                     vals.scale, vals.span), inv_perm)
        it = ops.transpose(ctx, TVal(idxs.ints.reshape(out_shape),
                                     0, idxs.span), inv_perm)
        return [vt, it]

    def _instancenorm(self, ctx, node, ins, align):
        """y = gamma * (x - mean_HW) / sqrt(var_HW + eps) + beta, per (N,C)
        instance (reference maps InstanceNorm to mean/var primitives)."""
        ra = self.run_args
        x, gamma, beta = ins[0], ins[1], ins[2]
        eps = node.attrs.get("epsilon", 1e-5)
        N, C = x.shape[0], x.shape[1]
        spatial = int(np.prod(x.shape[2:], dtype=np.int64)) or 1
        flat = TVal(x.ints.reshape(N * C, spatial), x.scale, x.span)
        s = ops.einsum(ctx, "rk->r", flat)
        mean = ops.div_known(ctx, s, spatial, s.scale)
        meanb = TVal(mean.ints.reshape(N * C, 1), mean.scale, mean.span)
        diff = ops.pairwise(ctx, "sub", flat, meanb)
        sq = ops.pairwise(ctx, "mul", diff, diff)
        vs = ops.einsum(ctx, "rk->r", sq)
        var = ops.div_known(ctx, vs, spatial, vs.scale)
        inv = ops.lookup_fn(
            ctx, f"rsqrt_e{eps}", var,
            lambda v: 1.0 / np.sqrt(np.maximum(v, 0) + eps),
            var.scale, ra.param_scale, ra.lookup_range)
        invb = TVal(inv.ints.reshape(N * C, 1), inv.scale, inv.span)
        normed = ops.pairwise(ctx, "mul", diff, invb)
        gb = TVal(np.tile(gamma.ints.reshape(C, 1), (N, 1)), gamma.scale, None)
        bb = TVal(np.tile(beta.ints.reshape(C, 1), (N, 1)), beta.scale, None)
        scaled = ops.pairwise(ctx, "mul", normed, gb)
        a2, b2 = align(scaled, bb)
        out = ops.pairwise(ctx, "add", a2, b2)
        return TVal(out.ints.reshape(x.shape), out.scale, out.span)

    def _layernorm(self, ctx, node, ins, align):
        """LayerNormalization over dims [axis:] with gamma/beta."""
        ra = self.run_args
        x = ins[0]
        gamma = ins[1] if len(ins) > 1 else None
        beta = ins[2] if len(ins) > 2 else None
        eps = node.attrs.get("epsilon", 1e-5)
        nd = x.ints.ndim
        axis = node.attrs.get("axis", -1) % nd
        runs = int(np.prod(x.shape[:axis], dtype=np.int64)) or 1
        rl = int(x.ints.size // runs)
        flat = TVal(x.ints.reshape(runs, rl), x.scale, x.span)
        s = ops.einsum(ctx, "rk->r", flat)
        mean = ops.div_known(ctx, s, rl, s.scale)
        meanb = TVal(mean.ints.reshape(runs, 1), mean.scale, mean.span)
        diff = ops.pairwise(ctx, "sub", flat, meanb)
        sq = ops.pairwise(ctx, "mul", diff, diff)
        vs = ops.einsum(ctx, "rk->r", sq)
        var = ops.div_known(ctx, vs, rl, vs.scale)
        inv = ops.lookup_fn(
            ctx, f"rsqrt_e{eps}", var,
            lambda v: 1.0 / np.sqrt(np.maximum(v, 0) + eps),
            var.scale, ra.param_scale, ra.lookup_range)
        invb = TVal(inv.ints.reshape(runs, 1), inv.scale, inv.span)
        out = ops.pairwise(ctx, "mul", diff, invb)
        if gamma is not None:
            gb = TVal(gamma.ints.reshape(1, rl), gamma.scale, gamma.span)
            out = ops.pairwise(ctx, "mul", out, gb)
        if beta is not None:
            bb = TVal(beta.ints.reshape(1, rl), beta.scale, beta.span)
            a2, b2 = align(out, bb)
            out = ops.pairwise(ctx, "add", a2, b2)
        return TVal(out.ints.reshape(x.shape), out.scale, out.span)

    def _recurrent(self, ctx, node, ins, align, rebase):
        """Unrolled single-direction RNN/GRU/LSTM cells (the reference maps
        these through tract's Scan subgraphs, `model.rs:783-969`; here the
        static seq length lets us unroll into matmul + lookup primitives)."""
        ra = self.run_args
        kind = node.op_type
        H = int(node.attrs.get("hidden_size"))
        direction = node.attrs.get("direction", b"forward")
        if isinstance(direction, bytes):
            direction = direction.decode()
        named = ins  # node.inputs with '' dropped: X, W, R, [B, initial_h, initial_c]
        X, W, R = named[0], named[1], named[2]
        B = named[3] if len(named) > 3 else None
        init_h = named[4] if len(named) > 4 else None
        init_c = named[5] if len(named) > 5 else None
        G = {"RNN": 1, "GRU": 3, "LSTM": 4}[kind]
        seq, batch, I = X.shape
        s = ra.input_scale
        assert W.span is None and R.span is None, \
            "recurrent weights must be constant"
        dirs = {"forward": [False], "reverse": [True],
                "bidirectional": [False, True]}[direction]
        D = len(dirs)

        per_dir = []
        for d, rev in enumerate(dirs):
            ys, h, c = self._recurrent_dir(
                ctx, align, kind, G, H, seq, batch, I, s, d, rev,
                X, W, R, B, init_h, init_c)
            per_dir.append((ys, h, c))
        # ONNX Y layout: (seq, num_directions, batch, H)
        y_rows = []
        for t in range(seq):
            for ys, _, _ in per_dir:
                y_rows.append(ys[t])
        Y = ops.concat(ctx, y_rows, 0) if len(y_rows) > 1 else y_rows[0]
        Y = TVal(Y.ints.reshape(seq, D, batch, H), Y.scale, Y.span)
        h_rows = [TVal(h.ints.reshape(1, batch, H), h.scale, h.span)
                  for _, h, _ in per_dir]
        Yh = ops.concat(ctx, h_rows, 0) if len(h_rows) > 1 else h_rows[0]
        outs = [Y, Yh]
        if kind == "LSTM":
            c_rows = [TVal(c.ints.reshape(1, batch, H), c.scale, c.span)
                      for _, _, c in per_dir]
            outs.append(ops.concat(ctx, c_rows, 0) if len(c_rows) > 1
                        else c_rows[0])
        return outs

    def _recurrent_dir(self, ctx, align, kind, G, H, seq, batch, I, s,
                       d, reverse, X, W, R, B, init_h, init_c):
        """One direction of an RNN/GRU/LSTM: unrolled cell chain over the
        (possibly reversed) sequence. d indexes the num_directions axis of
        W (D, G*H, I) / R (D, G*H, H) / B (D, 2*G*H) / init (D, batch, H)."""
        ra = self.run_args

        Wt = TVal(np.ascontiguousarray(
            W.ints.reshape(-1, G * H, I)[d].T), W.scale, None)
        Rt = TVal(np.ascontiguousarray(
            R.ints.reshape(-1, G * H, H)[d].T), R.scale, None)

        def requant_state(tv, shape):
            if tv is None:
                return TVal(np.zeros(shape, np.int64), s, None)
            f = (tv.ints.reshape(-1, *shape)[d].astype(np.float64)
                 / (1 << tv.scale))
            return TVal(quantize(f, s), s, None)

        h = requant_state(init_h, (batch, H))
        c = requant_state(init_c, (batch, H)) if kind == "LSTM" else None

        # bias split: B[d] = [Wb || Rb], each G*H
        wb = rb = None
        if B is not None:
            bf = (B.ints.reshape(-1, 2 * G * H)[d].astype(np.float64)
                  / (1 << B.scale))
            wb_f, rb_f = bf[:G * H], bf[G * H:]
            gate_scale = X.scale + W.scale
            wb = TVal(quantize(wb_f.reshape(1, G * H), gate_scale), gate_scale, None)
            rb = TVal(quantize(rb_f.reshape(1, G * H), s + R.scale), s + R.scale, None)

        def gate_slice(g, j):
            idx = (np.arange(batch)[:, None] * (G * H)
                   + np.arange(j * H, (j + 1) * H)[None, :])
            return ops.reindex(g, idx.reshape(-1), (batch, H))

        x_grid = np.arange(int(np.prod(X.shape, dtype=np.int64))).reshape(X.shape)
        t_order = range(seq - 1, -1, -1) if reverse else range(seq)
        ys_by_t = {}
        for t in t_order:
            xt = ops.reindex(X, x_grid[t].reshape(-1), (batch, I))
            gx = ops.matmul(ctx, xt, Wt)
            if wb is not None:
                a2, b2 = align(gx, wb)
                gx = ops.pairwise(ctx, "add", a2, b2)
            if h.span is None:
                ctx.materialize(h)
            gh = ops.matmul(ctx, h, Rt)
            if kind == "GRU" and rb is not None:
                a2, b2 = align(gh, rb)
                gh = ops.pairwise(ctx, "add", a2, b2)
            if kind == "RNN":
                a2, b2 = align(gx, gh)
                g = ops.pairwise(ctx, "add", a2, b2)
                if rb is not None:
                    a2, b2 = align(g, rb)
                    g = ops.pairwise(ctx, "add", a2, b2)
                h = ops.tanh_op(ctx, g, s, ra.lookup_range)
            elif kind == "GRU":
                # gates z, r; candidate h uses r * (H@R^T + Rb) (linear_before_reset)
                az, bz = align(gate_slice(gx, 0), gate_slice(gh, 0))
                z = ops.sigmoid(ctx, ops.pairwise(ctx, "add", az, bz), s,
                                ra.lookup_range)
                ar, br = align(gate_slice(gx, 1), gate_slice(gh, 1))
                r = ops.sigmoid(ctx, ops.pairwise(ctx, "add", ar, br), s,
                                ra.lookup_range)
                rgh = ops.pairwise(ctx, "mul", r, gate_slice(gh, 2))
                rgh = ops.div_rebase(ctx, rgh, s, ra.lookup_range)
                ah, bh = align(gate_slice(gx, 2), rgh)
                hh = ops.tanh_op(ctx, ops.pairwise(ctx, "add", ah, bh), s,
                                 ra.lookup_range)
                one = TVal(np.full(1, 1 << s, np.int64), s, None)
                notz = ops.pairwise(ctx, "sub", one, z)
                nh = ops.pairwise(ctx, "add",
                                  ops.pairwise(ctx, "mul", notz, hh),
                                  ops.pairwise(ctx, "mul", z, h))
                h = ops.div_rebase(ctx, nh, s, ra.lookup_range)
            else:  # LSTM: gate order i, o, f, c
                a2, b2 = align(gx, gh)
                g = ops.pairwise(ctx, "add", a2, b2)
                if rb is not None:
                    a2, b2 = align(g, rb)
                    g = ops.pairwise(ctx, "add", a2, b2)
                i_g = ops.sigmoid(ctx, gate_slice(g, 0), s, ra.lookup_range)
                o_g = ops.sigmoid(ctx, gate_slice(g, 1), s, ra.lookup_range)
                f_g = ops.sigmoid(ctx, gate_slice(g, 2), s, ra.lookup_range)
                cand = ops.tanh_op(ctx, gate_slice(g, 3), s, ra.lookup_range)
                if c.span is None:
                    ctx.materialize(c)
                c2 = ops.pairwise(ctx, "add",
                                  ops.pairwise(ctx, "mul", f_g, c),
                                  ops.pairwise(ctx, "mul", i_g, cand))
                c = ops.div_rebase(ctx, c2, s, ra.lookup_range)
                tc = ops.tanh_op(ctx, c, s, ra.lookup_range)
                nh = ops.pairwise(ctx, "mul", o_g, tc)
                h = ops.div_rebase(ctx, nh, s, ra.lookup_range)
            ys_by_t[t] = TVal(h.ints.reshape(1, 1, batch, H), h.scale, h.span)
        return [ys_by_t[t] for t in range(seq)], h, c

    def _batchnorm(self, ctx, node, ins, align):
        """Fold BN into a constant affine: y = x*gn + bn (host-folded)."""
        ra = self.run_args
        x, gamma, beta, mean, var = ins
        eps = node.attrs.get("epsilon", 1e-5)
        def fl(tv):
            return tv.ints.astype(np.float64) / (1 << tv.scale)
        g, b, m, v = fl(gamma), fl(beta), fl(mean), fl(var)
        scale_f = g / np.sqrt(v + eps)
        shift_f = b - m * scale_f
        shp = (1, -1) + (1,) * (x.ints.ndim - 2)
        sc = TVal(quantize(scale_f.reshape(shp), ra.param_scale), ra.param_scale, None)
        sh = TVal(quantize(shift_f.reshape(shp), x.scale + ra.param_scale),
                  x.scale + ra.param_scale, None)
        prod = ops.pairwise(ctx, "mul", x, sc)
        a2, b2 = align(prod, sh)
        return ops.pairwise(ctx, "add", a2, b2)


def _erf(x):
    import math
    return np.vectorize(math.erf)(np.asarray(x, np.float64))


def forward_float(model: "Model", input_arrays: list[np.ndarray],
                  return_all: bool = False):
    """Plain float64 reference forward (no quantization) — the calibration
    ground truth (the reference uses tract `run_onnx_predictions`,
    `model.rs:992-1026`; we evaluate the graph directly).

    return_all=True additionally returns the full name->value dict (used
    by `api.split_model` to size cut-boundary tensors)."""
    g = model.onnx.graph
    vals: dict[str, np.ndarray] = {}
    for ti, arr in zip(g.inputs, input_arrays):
        vals[ti.name] = np.asarray(arr, np.float64)
    for name, arr in g.initializers.items():
        vals[name] = np.asarray(arr, np.float64)
    for node in g.nodes:
        op = node.op_type
        ins = [vals[i] for i in node.inputs if i]
        if op == "Relu":
            out = np.maximum(ins[0], 0.0)
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-ins[0]))
        elif op == "Tanh":
            out = np.tanh(ins[0])
        elif op == "Exp":
            out = np.exp(ins[0])
        elif op in ("MatMul", "Gemm"):
            b = ins[1].T if (op == "Gemm" and node.attrs.get("transB")) else ins[1]
            out = ins[0] @ b
            if op == "Gemm" and len(ins) > 2:
                out = out + ins[2]
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Sub":
            out = ins[0] - ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Reshape":
            out = ins[0].reshape(_resolve_reshape(ins[0].shape, vals[node.inputs[1]]))
        elif op == "Flatten":
            axis = node.attrs.get("axis", 1)
            lead = int(np.prod(ins[0].shape[:axis])) or 1
            out = ins[0].reshape(lead, -1)
        elif op in ("Identity", "Cast"):
            out = ins[0]
        elif op == "Constant":
            out = np.asarray(node.attrs.get("value"), np.float64)
        elif op == "Softmax":
            e = np.exp(ins[0] - ins[0].max())
            out = e / e.sum()
        else:
            raise NotImplementedError(f"float forward: op {op}")
        vals[node.outputs[0]] = out
    outs = [vals[o.name] for o in g.outputs]
    return (outs, vals) if return_all else outs


def _transposed(ctx, tv: TVal) -> TVal:
    """Transpose a placed 2D tensor: same cells, permuted element order."""
    perm = np.arange(tv.ints.size).reshape(tv.shape).T.reshape(-1)
    return TVal(np.ascontiguousarray(tv.ints.T), tv.scale,
                dataclasses.replace(tv.span, rows=tv.span.rows[perm]))


def _resolve_reshape(cur_shape, shape_t) -> tuple:
    tgt = [int(s) for s in shape_t.reshape(-1)]
    total = int(np.prod(cur_shape, dtype=np.int64)) or 1
    if -1 in tgt:
        known = int(np.prod([s for s in tgt if s != -1], dtype=np.int64)) or 1
        tgt = [total // known if s == -1 else s for s in tgt]
    tgt = [cur_shape[i] if s == 0 else s for i, s in enumerate(tgt)]
    return tuple(tgt)


def _softmax(ctx, a: TVal, ra: RunArgs, axis: int = -1) -> TVal:
    """softmax = exp lookup -> per-slice sum -> recip lookup -> mul
    (reference `layouts.rs:6687`)."""
    nd = a.ints.ndim
    axis = axis % nd
    perm = [i for i in range(nd) if i != axis] + [axis]
    moved = ops.transpose(ctx, a, perm)
    rl = a.shape[axis]
    runs = int(a.ints.size // rl)
    flat = TVal(moved.ints.reshape(runs, rl), moved.scale, moved.span)
    ex = ops.exp_op(ctx, flat, ra.input_scale, ra.lookup_range)
    denom = ops.einsum(ctx, "rk->r", ex)
    inv = ops.lookup_fn(
        ctx, "recip", denom, lambda x: np.where(x == 0, 0.0, 1.0 / x),
        denom.scale, 2 * ra.input_scale, ra.lookup_range)
    inv2 = TVal(inv.ints.reshape(runs, 1), inv.scale, inv.span)
    prod = ops.pairwise(ctx, "mul", ex, inv2)
    out = ops.div_rebase(ctx, prod, prod.scale - ra.input_scale, ra.lookup_range)
    # undo the transpose
    inv_perm = np.argsort(perm)
    shaped = TVal(out.ints.reshape(tuple(a.shape[p] for p in perm)),
                  out.scale, out.span)
    return ops.transpose(ctx, shaped, inv_perm.tolist())

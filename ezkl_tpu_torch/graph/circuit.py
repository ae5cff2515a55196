"""GraphCircuit: settings, witness, and the prove/verify pipeline glue.

Mirror of the reference's `GraphCircuit`/`GraphSettings`/`GraphWitness`
(`ezkl/src/graph/mod.rs` — SURVEY.md §2.2) on top of our plonk
engine. Artifacts are JSON files shaped like ezkl's where practical:
settings.json (run_args + sizing), witness.json (inputs/outputs as field
hex + rescaled floats), proof.json.

Port of `ezkl_tpu/graph/circuit.py`: the layout runs on the host as there;
the calls into the PLONK layer (SRS, commitments of `kzgcommit` columns,
mock, keygen, prove) take a `device`, None meaning the card.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from ..fieldmath.spec import FR_MODULUS
from ..plonk import keygen, mock, prover, srs as srsmod, verifier
from .layout import BaseConfig, LayoutCtx, TVal
from .model import Model
from .quantize import dequantize
from .run_args import RunArgs

MIN_LOGROWS = 6


def _felt_hex(v: int) -> str:
    return "0x" + int(v % FR_MODULUS).to_bytes(32, "big").hex()


def _felt_from_i64(x: int) -> int:
    return x % FR_MODULUS


@dataclasses.dataclass
class GraphSettings:
    run_args: RunArgs
    num_rows: int
    total_assignments: int
    model_input_scales: list
    model_output_scales: list
    model_instance_shapes: list
    required_lookups: list
    version: str = "ezkl-tpu-0.1"

    def to_json(self) -> str:
        return json.dumps({
            "run_args": self.run_args.to_dict(),
            "num_rows": self.num_rows,
            "total_assignments": self.total_assignments,
            "model_input_scales": self.model_input_scales,
            "model_output_scales": self.model_output_scales,
            "model_instance_shapes": self.model_instance_shapes,
            "required_lookups": self.required_lookups,
            "version": self.version,
        }, indent=1)

    @classmethod
    def from_json(cls, s: str) -> "GraphSettings":
        d = json.loads(s)
        got = d.get("version", "?")
        if got != cls.version:
            # soft warning, matching the reference's artifact
            # version-mismatch check (`ezkl/src/lib.rs:473-496`):
            # old artifacts still load, but silent drift is surfaced
            import warnings
            warnings.warn(
                f"settings artifact version {got!r} != current "
                f"{cls.version!r}; regenerate with gen-settings if "
                f"behavior differs", stacklevel=2)
        return cls(
            run_args=RunArgs.from_dict(d["run_args"]),
            num_rows=d["num_rows"],
            total_assignments=d.get("total_assignments", d["num_rows"]),
            model_input_scales=d["model_input_scales"],
            model_output_scales=d["model_output_scales"],
            model_instance_shapes=d["model_instance_shapes"],
            required_lookups=d.get("required_lookups", []),
            version=d.get("version", "?"),
        )


class GraphCircuit:
    def __init__(self, model: Model):
        self.model = model
        self.run_args = model.run_args

    @classmethod
    def from_onnx(cls, path, run_args: RunArgs | None = None) -> "GraphCircuit":
        return cls(Model.load(path, run_args or RunArgs()))

    # -- layout/witness -----------------------------------------------------

    def _run_layout(self, input_arrays, k: int):
        from .modules import get_poseidon

        cfg = BaseConfig()
        ctx = LayoutCtx(cfg, k)
        ra = self.run_args
        outputs = self.model.layout(ctx, input_arrays)
        # instance order follows the reference: module hashes -> inputs ->
        # outputs (`graph/mod.rs:1411`)

        if ra.input_visibility == "hashed":
            mod = get_poseidon(cfg)
            for tv in self._input_tvals(ctx):
                hv, span = mod.hash(ctx, tv)
                base = len(ctx.instance_vals)
                ctx.instance_vals.append(hv)
                ctx.copy_rows(cfg.instance, [base], span.col, span.rows)
        if ra.param_visibility == "hashed":
            # params already live in advice (model.layout); hash each into
            # the instance (reference hashed-params, `graph/modules.rs`)
            mod = get_poseidon(cfg)
            for tv in getattr(ctx, "_param_tvals", []):
                hv, span = mod.hash(ctx, tv)
                base = len(ctx.instance_vals)
                ctx.instance_vals.append(hv)
                ctx.copy_rows(cfg.instance, [base], span.col, span.rows)
        if ra.output_visibility == "kzgcommit":
            # copy each output into a dedicated unblinded column at
            # canonical rows [0, size); its advice commitment IS the
            # public KZG commitment of the data — placement-independent,
            # so a downstream circuit committing the same tensor as its
            # input produces the identical commitment (proof splitting)
            for tv in outputs:
                ctx.stage_polycommit(tv)
        if ra.input_visibility == "public":
            for tv in self._input_tvals(ctx):
                flat = tv.ints.reshape(-1)
                base = len(ctx.instance_vals)
                ctx.instance_vals.extend(_felt_from_i64(int(x)) for x in flat)
                ctx.copy_rows(cfg.instance,
                              np.arange(base, base + flat.size),
                              tv.span.col, tv.span.rows)
        if ra.output_visibility == "hashed":
            mod = get_poseidon(cfg)
            for tv in outputs:
                hv, span = mod.hash(ctx, tv)
                base = len(ctx.instance_vals)
                ctx.instance_vals.append(hv)
                ctx.copy_rows(cfg.instance, [base], span.col, span.rows)
        elif ra.output_visibility == "public":
            for tv in outputs:
                flat = tv.ints.reshape(-1)
                base = len(ctx.instance_vals)
                ctx.instance_vals.extend(_felt_from_i64(int(x)) for x in flat)
                inst_rows = np.arange(base, base + flat.size)
                ctx.copy_rows(cfg.instance, inst_rows, tv.span.col,
                              tv.span.rows)
        return cfg, ctx, outputs

    def _input_tvals(self, ctx):
        return getattr(ctx, "_input_tvals", [])

    def gen_settings(self, sample_inputs=None, logrows: int | None = None) -> GraphSettings:
        """Build settings by a sizing layout pass (the reference's dummy
        pass + calc_min_logrows, `graph/mod.rs:1549-1731`)."""
        ra = self.run_args
        inputs = sample_inputs or [np.zeros(s, np.float64)
                                   for s in self.model.input_shapes()]
        probe_k = max(ra.logrows, 17)
        while True:
            try:
                cfg, ctx, outputs = self._run_layout(inputs, probe_k)
                break
            except ValueError as e:
                # sizing probe too small for the model: retry with more rows
                if "circuit overflow" not in str(e) or probe_k >= 26:
                    raise
                probe_k += 2
        table_rows = max(
            (info["inputs"].size for info in cfg.tables.values()), default=0)
        # +BLINDING_FACTORS+1: the proof system reserves the closing row and
        # the zero-knowledge blinding rows at the end of the domain.
        # Tables larger than the usable rows split into chunked column sets
        # (layout.py ensure_table), so they only force k up once a table
        # would need more than MAX_LOOKUP_COLS chunks — the analog of the
        # reference's MAX_NUM_LOOKUP_COLS=12 (`graph/mod.rs:79-83`).
        from ..plonk.cs import BLINDING_FACTORS, MAX_LOOKUP_COLS
        reserve = BLINDING_FACTORS + 1
        need = max(ctx.row + reserve,
                   -(-table_rows // MAX_LOOKUP_COLS) + reserve,
                   len(ctx.instance_vals) + 1)
        min_k = max(MIN_LOGROWS, (need - 1).bit_length())
        k = logrows if logrows is not None else min_k
        ra.logrows = k
        return GraphSettings(
            run_args=ra,
            num_rows=ctx.row,
            total_assignments=ctx.row,
            model_input_scales=self.model.input_scales(),
            model_output_scales=[tv.scale for tv in outputs],
            model_instance_shapes=[list(tv.shape) for tv in outputs],
            required_lookups=sorted(cfg.tables),
        )

    def forward(self, input_arrays):
        """Witness generation: returns (assignment-ready ctx parts + outputs)."""
        k = self.run_args.logrows
        cfg, ctx, outputs = self._run_layout(input_arrays, k)
        return cfg, ctx, outputs

    def gen_witness(self, input_arrays, srs: "srsmod.SRS | None" = None,
                    device=None) -> dict:
        """A given `srs` fixes the device of the commitments; else the SRS
        of the settled k is loaded or made on `device`."""
        cfg, ctx, outputs = self.forward(input_arrays)
        out = {
            "inputs": [[_felt_hex(int(v)) for v in quantized.reshape(-1)]
                       for quantized in
                       [np.asarray(a) for a in self._quantized_inputs(input_arrays)]],
            "outputs": [[_felt_hex(int(v)) for v in tv.ints.reshape(-1)]
                        for tv in outputs],
            "pretty_elements": {
                "rescaled_outputs": [
                    dequantize(tv.ints, tv.scale).reshape(-1).tolist()
                    for tv in outputs
                ],
            },
            "max_row": ctx.row,
        }
        if cfg.polycommit_cols:
            # native KZG commitments of the unblinded columns — the
            # reference's GraphModules::forward polycommit step
            # (`graph/modules.rs:289-335`); needs the SRS at witness time
            # exactly like `execute.rs:609-614`
            if srs is None:
                srs = srsmod.get_or_create(self.run_args.logrows, device=device)
            asg = ctx.finalize()
            from ..plonk import kzg
            from ..fieldmath import curve
            adv = asg.device_columns("advice", srs.g1.device)
            comms = []
            for col in cfg.polycommit_cols:
                pt = kzg.commit_lagrange(srs, adv[col.index])
                (dec,) = curve.decode_points(pt)
                comms.append(
                    [hex(dec[0]), hex(dec[1])] if dec else None)  # Fq coords
            out["processed_commitments"] = {
                "advice_indices": [c.index for c in cfg.polycommit_cols],
                "polycommit": comms,
            }
        return out

    def _quantized_inputs(self, input_arrays):
        from .quantize import quantize
        return [quantize(a, s)
                for a, s in zip(input_arrays, self.model.input_scales())]

    # -- proving pipeline ---------------------------------------------------

    MOCK_CHALLENGE = 0x1CEB00DA % FR_MODULUS

    def mock_prove(self, input_arrays, device=None) -> list:
        cfg, ctx, _ = self.forward(input_arrays)
        asg = ctx.finalize()
        challenges = None
        if asg.phase_callback is not None:
            challenges = {i: pow(self.MOCK_CHALLENGE, i + 1, FR_MODULUS)
                          for i in range(cfg.cs.num_challenges)}
            asg.apply_phase1(challenges)
        return mock.verify(asg, challenges, device=device)

    def setup(self, input_arrays, srs: srsmod.SRS, device=None):
        """keygen from a layout pass (fixed cols + copies define the vk)."""
        cfg, ctx, _ = self.forward(input_arrays)
        asg = ctx.finalize()
        pk = keygen.keygen(cfg.cs, self.run_args.logrows, srs, asg, device=device)
        return pk, asg

    def prove(self, input_arrays, srs: srsmod.SRS, pk=None, transcript=None,
              seed=None, device=None, checkpoint_dir=None):
        """Proves on the device of `pk` (or, keyed here, on `device`);
        `checkpoint_dir` as in `prover.create_proof`."""
        if pk is None:
            pk, asg = self.setup(input_arrays, srs, device=device)
        else:
            cfg, ctx, _ = self.forward(input_arrays)
            asg = ctx.finalize()
        return prover.create_proof(pk, srs, asg, transcript=transcript, seed=seed,
                                   checkpoint_dir=checkpoint_dir), pk

    @staticmethod
    def verify(vk, srs: srsmod.SRS, proof, transcript=None) -> bool:
        return verifier.verify(vk, srs.g2, srs.s_g2, proof,
                               transcript=transcript)

"""RunArgs: the circuit-shaping knob set.

Mirrors the reference's `RunArgs` (`ezkl/src/lib.rs:198-285`)
including validation (`:334-413`); names kept compatible so settings.json
files look familiar to ezkl users.

Port of `ezkl_tpu/graph/run_args.py` (pure numpy, copied; imports rewired to the
port's modules).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunArgs:
    input_scale: int = 7
    param_scale: int = 7
    scale_rebase_multiplier: int = 1
    lookup_range: tuple = (-32768, 32768)
    logrows: int = 17
    num_inner_cols: int = 2
    variables: dict = dataclasses.field(default_factory=lambda: {"batch_size": 1})
    input_visibility: str = "private"
    output_visibility: str = "public"
    param_visibility: str = "fixed"
    check_mode: str = "unsafe"
    decomp_base: int = 16384
    decomp_legs: int = 2
    tolerance: float = 0.0
    disable_freivalds: bool = False
    # skip the Input constrain-on-entry decompose (reference
    # `ignore_range_check_inputs_outputs`, lib.rs RunArgs; default FALSE =
    # inputs are range-bound as they enter the circuit)
    ignore_range_check_inputs_outputs: bool = False

    def validate(self):
        if self.param_visibility == "public":
            raise ValueError(
                "params cannot be public instances (use fixed or kzgcommit)")
        if self.scale_rebase_multiplier < 1:
            raise ValueError("scale_rebase_multiplier must be >= 1")
        if self.lookup_range[0] > self.lookup_range[1]:
            raise ValueError("lookup_range min > max")
        if self.logrows < 4 or self.logrows > 28:
            raise ValueError("logrows out of range")
        if self.decomp_base < 2 or self.decomp_legs < 1:
            raise ValueError("bad decomposition params")
        return self

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["lookup_range"] = list(self.lookup_range)
        d["variables"] = [[k, v] for k, v in self.variables.items()]
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        d.pop("tolerance_obj", None)
        if isinstance(d.get("tolerance"), dict):
            d["tolerance"] = d["tolerance"].get("val", 0.0)
        if "lookup_range" in d:
            d["lookup_range"] = tuple(d["lookup_range"])
        if isinstance(d.get("variables"), list):
            d["variables"] = {k: v for k, v in d["variables"]}
        for vis in ("input_visibility", "output_visibility", "param_visibility"):
            if vis in d and isinstance(d[vis], str):
                d[vis] = d[vis].lower()
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

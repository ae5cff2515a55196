"""Entry `api_prove`: the flow of a CLI or Python-binding user,
`ezkl_tpu_torch.api.prove`, which reads the compiled circuit, `pk.key`, the
SRS file and the input's JSON on every proof and writes the proof's JSON.
Set-up writes the key and the SRS once; each proof gets an input file and a
proof file of its own.
"""

from __future__ import annotations

import json
import pathlib


class Entry:
    def __init__(self, program, traffic: dict):
        from ezkl_tpu_torch.plonk import serde, srs as srsmod
        self.program = program
        srsmod.save(program.srs, program.files["kzg.srs"])
        serde.save_pk(program.pk, program.files["pk.key"])
        self.count = 0

    def prove(self, x):
        from ezkl_tpu_torch import api
        p = self.program
        i = self.count
        self.count += 1
        inp = p.workdir / f"input_{i}.json"
        out = p.workdir / f"proof_{i}.json"
        inp.write_text(json.dumps({"input_data": [x.reshape(-1).tolist()]}))
        api.prove(p.files["model.compiled"], str(inp), p.files["pk.key"],
                  p.files["kzg.srs"], str(out), device=p.device)
        return out

    def answer_text(self, answer) -> str:
        return pathlib.Path(answer).read_text()

    def close(self):
        self.program = None

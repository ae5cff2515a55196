"""Per proof, seconds outside `create_proof`'s phases: the proof's wall time
less the sum of its `_span` phases. That is the graph layer's layout and
witness, and in the file entry also the loads of the compiled circuit,
`pk.key`, the SRS and the input, and the proof's write (`api`, `serde`)."""

UNIT, SOURCE = "s", "program_span"
LAYER = "graph and file API (graph/, api.py, plonk/serde.py)"
MOVES = "prove_s"


def read(r):
    vals = [p["wall_s"] - sum(p["phases"].values()) for p in r.proofs if p["phases"]]
    return sum(vals) / len(vals) if vals else None

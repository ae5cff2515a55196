"""Entry `graph_prove`: the in-memory proving path of a Python user,
`GraphCircuit.prove(arrays, srs, pk=pk)` on a key kept in memory. Each
proof lays out the witness of its input and proves it with fresh blinding.
"""

from __future__ import annotations


class Entry:
    def __init__(self, program, traffic: dict):
        self.program = program

    def prove(self, x):
        p = self.program
        proof, _ = p.gc.prove([x], p.srs, pk=p.pk)
        return proof

    def answer_text(self, answer) -> str:
        """The proof's JSON text, as `api.prove` writes it."""
        return answer.to_json()

    def close(self):
        self.program = None

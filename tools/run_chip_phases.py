#!/usr/bin/env python3
"""Run chosen phases of `chip_smoke.py` on one card, in order, for a shorter
chip call while a phase is developed (`chip_smoke.py` itself always runs
every phase).

    python3 tools/run_chip_phases.py k20 prove resume graph conv

Phases: `kernels` (every kernel at the k = 14 shapes), `k20` (the kernels
at the k = 20 path's widths), `prove` (the k = 14 stand-in), `resume` (crash
and resume of the stand-in's prove; runs `prove` first), `check`, `graph`
(mlp_4d), `conv` (conv2d_mnist at k = 20 and the aggregate; runs `graph`
first), `evm` (the EVM verifier on conv2d_mnist and mlp_4d; runs `graph`
and `conv` first), `mesh` (the four-shard mesh; runs `prove` first, and
reads the k = 20 SRS of `conv` when that ran, else makes it), `poseidon`,
`families` (the recurrent, attention, dynamic-gather and committed-I/O
circuits, the LSTM at k = 17 and the attention block at k = 18).
Exits non-zero if a phase fails.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(names) -> int:
    import torch
    from ezkl_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("run_chip_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.emit({"phase": "device", "nvidia_smi": cs.nvidia_smi(), "torch": torch.__version__})
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.lib()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(cs.SEED)
    seconds, stand_in = {}, None
    with tempfile.TemporaryDirectory() as wd:
        wd = pathlib.Path(wd)
        for name in names:
            t0 = time.perf_counter()
            if name == "kernels":
                cs.check_kernels(dev, rng)
            elif name == "k20":
                cs.check_k20_widths(dev, rng)
            elif name in ("prove", "resume", "check"):
                if stand_in is None:
                    stand_in = cs.prove(dev, rng)
                if name == "resume":
                    pk, asg, baseline = stand_in[3]
                    cs.resume(dev, pk, stand_in[0], asg, baseline, wd / "resume")
                if name == "check":
                    cs.check_outputs(dev, rng, stand_in[0])
            elif name in ("graph", "conv", "evm"):
                if not (wd / cs.GRAPH_MODEL / "vk.key").exists():
                    cs.graph(dev, wd / cs.GRAPH_MODEL)
                if name != "graph" and not (wd / cs.CONV_MODEL / "vk.key").exists():
                    cs.conv(dev, wd / cs.CONV_MODEL, (wd / cs.GRAPH_MODEL / "proof.json",
                                                      wd / cs.GRAPH_MODEL / "vk.key"))
                if name == "evm":
                    cs.evm(dev, wd / cs.CONV_MODEL, wd / cs.GRAPH_MODEL)
            elif name == "mesh":
                if stand_in is None:
                    stand_in = cs.prove(dev, rng)
                srs20 = wd / cs.CONV_MODEL / "kzg.srs"
                cs.mesh(dev, rng, (stand_in[0], *stand_in[3]),
                        srs20 if srs20.exists() else None)
            elif name == "poseidon":
                cs.poseidon(dev, rng)
            elif name == "families":
                cs.families(dev, wd / "families")
            else:
                raise SystemExit(f"unknown phase {name!r}")
            seconds[name] = time.perf_counter() - t0
    cs.emit({"phase": "times", **seconds})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

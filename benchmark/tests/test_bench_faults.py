"""Whole runs of the harness on the CPU at tiny size (its look for a card
skipped): a sound run is `correct`; the control, the program at one bit
less of fixed-point scale, is not; nor is a run whose timed path is broken
underneath, once for each fault a prover can have. Each run keys and proves
on the CPU, so each takes a minute or more."""

import json
import pathlib
import time
import types

import pytest
import torch

from benchmark import faults, harness

TINY = json.loads((pathlib.Path(__file__).parent / "tiny_mlp.json").read_text())
TRAFFIC = json.loads((harness.BENCH / "traffic" / "prove_loop.json").read_text())


def _run(capsys, control=None, fault=None, seconds=0.0, seed=2**31 + 21, traffic=TRAFFIC):
    spec = harness.load_spec()
    c = harness.Cell("tiny_mlp.prove_loop", 1, TINY, traffic, spec["end_to_end"],
                     spec["per_layer"])
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0, control=control)
    rc = harness.run(c, args, torch.device("cpu"), time.perf_counter(), entry_override=fault)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(capsys):
    out = _run(capsys)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == 1
    assert all(v["value"] == 0 for v in out["compared"].values())
    assert set(out["metrics"]) == {"prove_s", "setup_s"}       # no peak on the CPU


def test_the_control_is_not_correct(capsys):
    # at this seed the window's input has outputs that the lower scale
    # changes (at 2^31 + 21 it does not: a tiny model's outputs are coarse)
    out = _run(capsys, control="scale3", seed=2**31 + 22)
    assert out["correct"] is False
    assert out["compared"]["output_gap"]["value"] >= 1
    assert out["compared"]["proofs_rejected"]["value"] == 0     # a valid proof of other outputs


@pytest.mark.parametrize("kind", faults.KINDS)
def test_a_broken_prover_is_not_correct(capsys, monkeypatch, kind):
    from ezkl_tpu_torch.plonk import srs as srsmod
    monkeypatch.setattr(srsmod, "gen_srs", srsmod.gen_srs)     # undone after the test
    # at this seed the window's input and the warm-up's have other outputs,
    # so the stale proof carries the wrong ones
    out = _run(capsys, fault=faults.plant(kind))
    assert out["correct"] is False
    failing = {k for k, v in out["compared"].items() if v["value"] > v["limit"]}
    assert failing


@pytest.mark.parametrize("kind", ["eval", "output"])
def test_a_broken_file_prover_is_not_correct(capsys, kind):
    """The file entry's proof.json altered where `api.prove` writes it."""
    traffic = json.loads((harness.BENCH / "traffic" / "file_api.json").read_text())
    out = _run(capsys, fault=faults.plant(kind), traffic=traffic)
    assert out["correct"] is False
    assert out["compared"]["proofs_rejected"]["value"] >= 1

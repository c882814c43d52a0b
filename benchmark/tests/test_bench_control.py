"""The control must come out as not correct: the plain reference computed in
TF32 (the configurations state fp32 with TF32 off), put in the program's
place, fails at least one of a cell's limits. On the card only; at a batch a
test run holds (the cells' own sizes: ``python3 -m benchmark.harness.controls``)."""

import json

import pytest

from benchmark.harness import controls
from benchmark.harness.cell import benchmark_file, settings
from benchmark.harness.env import ROOT

CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell, card):
    overrides = {"cfg.recipe.batch": 32} if "pretrain" in cell else {"traffic.sample_requests": 8}
    run = settings(benchmark_file(), cell, 2 ** 31 + 101, 10.0, False, card, 0.0,
                   overrides=overrides)
    out = controls.training(run) if run.traffic["kind"] == "train" else controls.serving(run)
    failed = [name for name, value in out["control"].items()
              if value > run.limits.get(name, float("inf"))]
    assert failed, (out, run.limits)

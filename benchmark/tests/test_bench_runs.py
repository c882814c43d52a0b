"""Whole runs of every cell at a tiny size on the CPU: the program against
the plain reference, the faults that ``correct`` must catch, the modules a
run loads, and the refusals of the command."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.env import ROOT, forbidden_loaded
from benchmark.tests._tiny import run_tiny

CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TRAIN_CELLS = [c for c in CELLS if "pretrain" in c]
SERVE_CELLS = [c for c in CELLS if "serve" in c]


@pytest.mark.parametrize("cell", CELLS)
def test_program_matches_reference(cell):
    result = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell", [TRAIN_CELLS[0], SERVE_CELLS[0]])
def test_traced_run_reads_layer_metrics(cell):
    result = run_tiny(cell, trace=True)
    assert result["correct"], result["checks"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    # on the CPU no kernel runs: every share of the device is absent or idle
    assert "fused_attention_roofline" not in result["metrics"]
    assert result["metrics"]


def test_fault_step_leaves_state_unchanged(monkeypatch):
    from gm3d_tpu_torch.train import optim

    monkeypatch.setattr(optim.ClippedAdamW, "step", lambda self, closure=None: None)
    result = run_tiny(TRAIN_CELLS[0])
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] >= 0.99
    assert result["checks"]["ema_change_gap"]["value"] >= 0.99


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_fault_wrong_ema_decay(cell, monkeypatch):
    """The EMA moved at 0.999 where the epoch's decay is 0.9999: ten times
    its change, while the student's steps are untouched."""
    from gm3d_tpu_torch.train import pretrain

    original = pretrain.ema_update
    monkeypatch.setattr(pretrain, "ema_update",
                        lambda ema, new, decay: original(ema, new, 0.999))
    result = run_tiny(cell)
    assert not result["correct"]
    assert result["checks"]["ema_change_gap"]["value"] > 1.0


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_fault_half_the_batch(cell, monkeypatch):
    from benchmark.tests._tiny import tiny_run

    run = tiny_run(cell)
    original = run.cfgmod.TrainProgram.step
    monkeypatch.setattr(run.cfgmod.TrainProgram, "step",
                        lambda self, pts: original(self, pts[: pts.shape[0] // 2]))
    from benchmark.harness.cell import benchmark_file, run_cell

    assert not run_cell(run, benchmark_file())["correct"]


def test_fault_answer_altered(monkeypatch):
    from gm3d_tpu_torch.serve.runner import ServingModel

    original = ServingModel.predict

    def altered(self, points, cls_label=None):
        out = original(self, points, cls_label).copy()
        out[..., 0] += 1e-3 * (abs(out).max() + 1.0)
        return out

    monkeypatch.setattr(ServingModel, "predict", altered)
    result = run_tiny(SERVE_CELLS[0])
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] > result["checks"]["logit_gap"]["limit"]


def test_forbidden_names_compared_whole():
    assert forbidden_loaded(["gm3d_tpu_torch", "gm3d_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_loaded(["jax.numpy", "gm3d_tpu.ops", "flax"]) == ["flax", "gm3d_tpu.ops",
                                                                       "jax.numpy"]


@pytest.mark.parametrize("cell", [TRAIN_CELLS[0], SERVE_CELLS[0]])
def test_a_run_loads_no_jax(cell):
    code = ("import sys; from benchmark.tests._tiny import run_tiny; "
            f"run_tiny({cell!r}); from benchmark.harness.env import forbidden_loaded; "
            "print(forbidden_loaded(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card(tmp_path):
    """No CUDA device here: the command exits non-zero and prints no result,
    also in a folder that holds only BENCHMARK.json and the benchmark."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                              "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=where,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""

"""Tiny sizes of the benchmark's configurations, for runs on the CPU: every
width cut, so that a whole run takes seconds. Only tests use them."""

import time

import torch

from benchmark.harness.cell import benchmark_file, run_cell, settings

POINT_MAE = {}
for part in ("student", "teacher"):
    POINT_MAE.update({f"cfg.{part}.{k}": v for k, v in dict(
        trans_dim=48, depth=2, num_heads=2, decoder_depth=2, decoder_num_heads=2,
        group_size=8, num_group=16, encoder_dims=48).items()})
POINT_MAE.update({f"cfg.classifier.{k}": v for k, v in dict(
    trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48).items()})
POINT_MAE.update({"cfg.npoints": 128, "cfg.recipe.batch": 4, "cfg.serve.export_batch": 8})
POINT_M2AE = {"cfg.model.num_groups": [64, 32, 8], "cfg.model.group_sizes": [8, 4, 4],
              "cfg.model.encoder_depths": [2, 2, 2], "cfg.model.encoder_dims": [24, 48, 96],
              "cfg.model.decoder_dims": [96, 48], "cfg.npoints": 256, "cfg.recipe.batch": 4}
TRAIN = {"traffic.dataset_clouds": 48, "traffic.num_workers": 1, "traffic.trace_after_steps": 1,
         "traffic.trace_steps": 2}
SERVE = {"traffic.rate_clouds_per_s": 60.0, "traffic.bank_clouds": 64,
         "traffic.connections": 4, "traffic.warmup_requests": 8, "traffic.sample_requests": 6, "traffic.warmup_connections": 2,
         "traffic.sample_largest": 2, "traffic.trace_s": 0.5}
# limits at these sizes: the program and the reference both run plain fp32 on the CPU
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4, "ema_change_gap": 2e-3,
          "logit_gap": 1e-5}


def overrides(cell: str) -> dict:
    out = dict(POINT_M2AE if cell.startswith("point_m2ae") else POINT_MAE)
    out.update(SERVE if "serve" in cell else TRAIN)
    return out


def tiny_run(cell: str, seed: int = 2 ** 31 + 5, seconds: float = 1.5, trace: bool = False):
    """The cell's settings at the tiny size on the CPU, with the tiny limits."""
    torch.set_num_threads(2)
    run = settings(benchmark_file(), cell, seed, seconds, trace, torch.device("cpu"),
                   time.perf_counter(), overrides=overrides(cell))
    run.limits = {k: LIMITS.get(k, v) for k, v in run.limits.items()}
    return run


def run_tiny(cell: str, **kwargs) -> dict:
    return run_cell(tiny_run(cell, **kwargs), benchmark_file())

"""Stage times of one GM3D pretrain step on the GPU, by the step's own
stage spans (``utils/profiling.py::stage_ms``: CUDA events at each stage boundary).

    python3 -m gm3d_tpu_torch.scripts.profile_pretrain [--batch 256] [--steps 5]
        [--plain] [--depth 12]
    python3 -m gm3d_tpu_torch.scripts.profile_pretrain --family m2ae_gm3d
        [--batch 128] [--npoints 2048]

Builds student, EMA copy and frozen teacher at full width (weights from
``--seed``, BatchNorm statistics non-trivial), takes ``--steps`` steps of
``train.pretrain.make_gm3d_train_step`` on random clouds, and prints one JSON
line: the median time of each stage (augment + group, the two fused patch
embeds, EMA forward + mask, student forward, teacher, losses, backward,
optimizer + EMA), of the whole step (events and wall clock), clouds per
second, kernel launches a step, peak memory, and the card's name and power
limit. ``--plain`` runs the same step with ``use_fused_embed=False,
use_fused_attention=False`` (the unfused modules) for comparison.

``--family m2ae_gm3d`` profiles the Point-M2AE + GM3D step instead
(``configs/m2ae/config_Point_M2AE.yaml`` at full width, its EMA copy, AdamW
clipped at 5; B 128 x 2,048 points by default): augment + hierarchy, EMA
forward + mask, student forward, losses, backward, optimizer + EMA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from typing import Optional

import torch

from gm3d_tpu_torch.config import build_model_from_cfg, cfg_from_yaml_file
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.ops.fps import fps_indices
from gm3d_tpu_torch.ops.fused_attention import fused_attention, fused_attention_backward
from gm3d_tpu_torch.ops.knn import knn_indices
from gm3d_tpu_torch.ops.patch_embed import fused_patch_embed
from gm3d_tpu_torch.train.optim import build_adamw, build_gm3d_shared_optimizer
from gm3d_tpu_torch.train.pretrain import make_gm3d_train_step, make_m2ae_gm3d_train_step
from gm3d_tpu_torch.train.state import TrainState, create_train_state
from gm3d_tpu_torch.utils.device import resolve_device
from gm3d_tpu_torch.utils.profiling import clear, recording, stage_ms

STAGES = ("augment_group", "patch_embed", "ema_forward_mask", "student_forward", "teacher",
          "losses", "backward", "optimizer_ema")
M2AE_STAGES = ("augment_hierarchy", "ema_forward_mask", "student_forward", "losses", "backward",
               "optimizer_ema")
M2AE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                           "configs", "m2ae", "config_Point_M2AE.yaml")
SCALARS = {"ema_decay": 0.999, "keep_ratio": 0.4, "w_mse": 1.0, "w_cd": 1.0}
KERNELS = {"fps": fps_indices, "knn": knn_indices, "patch_embed": fused_patch_embed,
           "attention_fwd": fused_attention, "attention_bwd": fused_attention_backward}


def randomize_batchnorm_(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Running statistics and affine parameters away from (0, 1), as after
    some training."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                shape = m.running_mean.shape
                m.running_mean.copy_(torch.randn(shape, generator=generator) * 0.05)
                m.running_var.copy_(torch.rand(shape, generator=generator) * 0.5 + 0.75)
                m.weight.copy_(torch.rand(shape, generator=generator) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(shape, generator=generator) * 0.05)


def build_pretrain_setup(seed: int = 0, device="cuda", learning_rate: float = 1e-3,
                         **model_kwargs):
    """(state, teacher): a GM3D student with its EMA copy and optimizer, and a
    frozen Point-MAE teacher, on ``device``, weights drawn from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    student, teacher = GM3DStudent(**model_kwargs), PointMAE(**model_kwargs)
    for model in (student, teacher):
        model.reset_parameters(gen)
        randomize_batchnorm_(model, gen)
    with torch.no_grad():  # the mask tokens start at zero: move them off it
        for token in (student.mask_token, student.mask_token_loss_pred):
            token.copy_(torch.randn(token.shape, generator=gen) * 0.02)
    student.to(dev)
    teacher.to(dev).eval()
    optimizer = build_gm3d_shared_optimizer(student, learning_rate)
    return create_train_state(student, optimizer, with_ema=True), teacher


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def build_m2ae_setup(seed: int = 0, device="cuda", learning_rate: float = 1e-3,
                     config: str = M2AE_CONFIG) -> TrainState:
    """A Point-M2AE of ``config`` with its EMA copy and its optimizer (AdamW,
    clipped at 5, as the CLI's ``m2ae_gm3d``) on ``device``, weights and
    BatchNorm statistics drawn from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = build_model_from_cfg(cfg_from_yaml_file(config)["model"])
    model.reset_parameters(gen)
    randomize_batchnorm_(model, gen)
    model.to(dev)
    optimizer = build_adamw(model.named_parameters(), learning_rate, grad_clip=5.0)
    return create_train_state(model, optimizer, with_ema=True)


def profile(state: TrainState, teacher, batch: int, npoints: int, steps: int, warmup: int,
            plain: bool, seed: int = 1, family: str = "gm3d") -> dict:
    dev = next(state.student.parameters()).device
    if family == "m2ae_gm3d":
        step = make_m2ae_gm3d_train_step(state.student, state.optimizer, device=dev)
        stages = M2AE_STAGES
    else:
        step = make_gm3d_train_step(state.student, teacher, state.optimizer,
                                    use_fused_embed=not plain, use_fused_attention=not plain,
                                    device=dev)
        stages = STAGES
    gen = torch.Generator(device=dev).manual_seed(seed)
    wall_ms = []
    launches: Optional[dict] = None
    torch.cuda.reset_peak_memory_stats(dev)
    with recording():
        for i in range(warmup + steps):
            if i == warmup:
                clear()  # the stage times of the timed steps only
            pts = torch.randn((batch, npoints, 3), generator=gen, device=dev) * 0.5
            reset_launches()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, metrics = step(state, pts, gen, SCALARS)
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3
            if not all(bool(torch.isfinite(v)) for v in metrics.values()):
                raise RuntimeError(f"non-finite metrics at step {i}: {metrics}")
            if i >= warmup:
                launches = read_launches()
                wall_ms.append(wall)
    per_step = stage_ms()
    clear()
    whole_ms = [sum(s.values()) for s in per_step]
    step_ms = statistics.median(whole_ms)
    return {
        "family": family,
        "route": "plain modules" if plain else "kernels",
        "batch": batch, "npoints": npoints, "steps": steps,
        "stage_ms": {k: statistics.median(s[k] for s in per_step) for k in stages},
        "step_ms_events": step_ms,
        "step_ms_wall": statistics.median(wall_ms),
        "clouds_per_s": batch / statistics.median(wall_ms) * 1e3,
        "launches_per_step": launches,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "metrics_last_step": {k: float(v) for k, v in metrics.items()},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=["gm3d", "m2ae_gm3d"], default="gm3d")
    ap.add_argument("--batch", type=int, default=None,
                    help="clouds a step (default 256, m2ae_gm3d 128)")
    ap.add_argument("--npoints", type=int, default=None,
                    help="points a cloud (default 1024, m2ae_gm3d 2048)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--depth", type=int, default=12, help="encoder depth (12 = full)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plain", action="store_true",
                    help="the unfused modules in place of the three matrix kernels")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_pretrain times the GPU: it has nothing to say about a CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m2ae = args.family == "m2ae_gm3d"
    if m2ae and args.plain:
        raise SystemExit("--plain compares the GM3D step's kernels; the M2AE step takes "
                         "no patch-embed or attention kernel by default")
    batch = args.batch or (128 if m2ae else 256)
    npoints = args.npoints or (2048 if m2ae else 1024)
    if m2ae:
        state, teacher = build_m2ae_setup(args.seed, dev), None
    else:
        state, teacher = build_pretrain_setup(args.seed, dev, depth=args.depth)
    out = profile(state, teacher, batch, npoints, args.steps, args.warmup, args.plain,
                  family=args.family)
    out["gpu"] = gpu_name_and_limit()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

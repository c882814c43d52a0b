"""Stage times of one GM3D pretrain step on the GPU, by CUDA events.

    python3 -m gm3d_tpu_torch.scripts.profile_pretrain [--batch 256] [--steps 5]
        [--plain] [--depth 12]

Builds student, EMA copy and frozen teacher at full width (weights from
``--seed``, BatchNorm statistics non-trivial), takes ``--steps`` steps of
``train.pretrain.make_gm3d_train_step`` on random clouds, and prints one JSON
line: the median time of each stage (augment + group, the two fused patch
embeds, EMA forward + mask, student forward, teacher, losses, backward,
optimizer + EMA), of the whole step (events and wall clock), clouds per
second, kernel launches a step, peak memory, and the card's name and power
limit. ``--plain`` runs the same step with ``use_fused_embed=False,
use_fused_attention=False`` (the unfused modules) for comparison.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Optional

import torch

from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.ops.fps import fps_indices
from gm3d_tpu_torch.ops.fused_attention import fused_attention, fused_attention_backward
from gm3d_tpu_torch.ops.knn import knn_indices
from gm3d_tpu_torch.ops.patch_embed import fused_patch_embed
from gm3d_tpu_torch.train.optim import build_gm3d_shared_optimizer
from gm3d_tpu_torch.train.pretrain import make_gm3d_train_step
from gm3d_tpu_torch.train.state import TrainState, create_train_state
from gm3d_tpu_torch.utils.device import resolve_device

STAGES = ("augment_group", "patch_embed", "ema_forward_mask", "student_forward", "teacher",
          "losses", "backward", "optimizer_ema")
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


def profile(state: TrainState, teacher, batch: int, npoints: int, steps: int, warmup: int,
            plain: bool, seed: int = 1) -> dict:
    dev = next(state.student.parameters()).device
    step = make_gm3d_train_step(state.student, teacher, state.optimizer,
                                use_fused_embed=not plain, use_fused_attention=not plain,
                                device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    per_stage = {name: [] for name in STAGES}
    whole_ms, wall_ms = [], []
    launches: Optional[dict] = None
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(warmup + steps):
        pts = torch.randn((batch, npoints, 3), generator=gen, device=dev) * 0.5
        events = [("start", torch.cuda.Event(enable_timing=True))]

        def mark(stage: str) -> None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        reset_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        events[0][1].record()
        state, metrics = step(state, pts, gen, SCALARS, mark=mark)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise RuntimeError(f"non-finite metrics at step {i}: {metrics}")
        if i < warmup:
            continue
        launches = read_launches()
        wall_ms.append(wall)
        whole_ms.append(events[0][1].elapsed_time(events[-1][1]))
        for (_, prev), (stage, ev) in zip(events, events[1:]):
            per_stage[stage].append(prev.elapsed_time(ev))
    step_ms = statistics.median(whole_ms)
    return {
        "route": "plain modules" if plain else "kernels",
        "batch": batch, "npoints": npoints, "steps": steps,
        "stage_ms": {k: statistics.median(v) for k, v in per_stage.items()},
        "step_ms_events": step_ms,
        "step_ms_wall": statistics.median(wall_ms),
        "clouds_per_s": batch / statistics.median(wall_ms) * 1e3,
        "launches_per_step": launches,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "metrics_last_step": {k: float(v) for k, v in metrics.items()},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--npoints", type=int, default=1024)
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
    state, teacher = build_pretrain_setup(args.seed, dev, depth=args.depth)
    out = profile(state, teacher, args.batch, args.npoints, args.steps, args.warmup, args.plain)
    out["gpu"] = gpu_name_and_limit()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

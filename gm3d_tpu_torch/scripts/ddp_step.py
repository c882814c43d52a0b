"""Full-width GM3D pretrain steps, data-parallel, one process a rank.

Every rank builds the same state (weights from ``--seed``), reads the same
global batches (standard-normal clouds from ``--seed``) and keeps its rows;
the draws come from one generator seeded alike on every rank and are the
global batch's (``parallel/``). Each rank writes ``rank{R}.json`` into
``--out``: the steps' metrics (averaged over ranks), each step's kernel
launches on this rank, its wall ms a step (host clock around a synchronised
step), and the wall ms of the gradients' all-reduce alone (the step's one
large collective: ``gradient_bytes`` of fp32)::

  torchrun --nproc_per_node 2 -m gm3d_tpu_torch.scripts.ddp_step --device cpu --batch 4 --out /tmp/ddp
  torchrun --nproc_per_node N -m gm3d_tpu_torch.scripts.ddp_step --out /tmp/ddp   # N GPUs, NCCL

``--device cuda:0`` puts every rank on card 0 over gloo (NCCL refuses two
ranks on one card): a check of the data-parallel path on one GPU, whose
times are those of a card shared by the ranks, not a scaling figure.
``run_steps`` in a process without a group computes the same steps in one
process on the global batch, for comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from gm3d_tpu_torch.cli.pretrain import step_draws
from gm3d_tpu_torch.parallel.mesh import average_gradients, make_mesh, shard_batch
from gm3d_tpu_torch.parallel.multihost import shutdown
from gm3d_tpu_torch.scripts import profile_pretrain as pp
from gm3d_tpu_torch.train.pretrain import METRIC_KEYS, make_gm3d_train_step

NPOINTS = 1024


def global_batch(seed: int, step: int, batch: int) -> torch.Tensor:
    """Step ``step``'s global batch of standard-normal clouds (on the host)."""
    rng = np.random.default_rng([seed, step])
    return torch.from_numpy((rng.standard_normal((batch, NPOINTS, 3)) * 0.5)
                            .astype(np.float32))


def run_steps(device: torch.device, batch: int, steps: int, seed: int) -> dict:
    """``steps`` GM3D steps on this process's rows of each global batch:
    metrics, launches and wall ms of each step."""
    state, teacher = pp.build_pretrain_setup(seed=seed, device=device)
    step = make_gm3d_train_step(state.student, teacher, state.optimizer, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out = {"metrics": [], "launches": [], "ms_wall": []}
    for i in range(steps):
        pts = shard_batch(global_batch(seed, i, batch)).to(device)
        draws = step_draws(gen, pts.shape[0], state.student.num_group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        pp.reset_launches()
        t0 = time.perf_counter()
        state, metrics = step(state, pts, gen, pp.SCALARS, draws=draws)
        values = {k: float(metrics[k]) for k in METRIC_KEYS}  # waits for the step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out["ms_wall"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(pp.read_launches())
        out["metrics"].append(values)
    params = [p for p in state.student.parameters() if p.grad is not None]
    out["gradient_bytes"] = sum(p.grad.numel() * p.grad.element_size() for p in params)
    out["allreduce_ms_wall"] = [_wall_ms(lambda: average_gradients(params), device)
                                for _ in range(3)]
    return out


def _wall_ms(fn, device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda: a card a rank (NCCL); cuda:K: every rank on card K (gloo); "
                        "cpu (gloo)")
    p.add_argument("--batch", type=int, default=256, help="the global batch")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = make_mesh(None, args.device)
    device = ctx.device if ctx is not None else torch.device(args.device)
    try:
        res = run_steps(device, args.batch, args.steps, args.seed)
    finally:
        rank = 0 if ctx is None else ctx.rank
        backend = None if ctx is None else torch.distributed.get_backend()
        world = 1 if ctx is None else ctx.world
        shutdown()
    res.update(rank=rank, world=world, backend=backend, device=str(device),
               batch_per_rank=args.batch // world)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()

"""Reconstruction and predicted-loss heatmap PLY dumps from the command line.

Port of ``gm3d_tpu/cli/visualize.py`` (reference ``tools/runner.py``
test_net and the PLY attention-map dumps)::

  python -m gm3d_tpu_torch.cli.visualize --config configs/pointmae/config_m.yaml \\
      --ckpt experiments/teacher/ckpt --synthetic --out_dir ./vis --heatmap

writes ``<out_dir>/vis_<b>.ply`` for the first ``--num_samples`` clouds of
the config's validation set (``--synthetic``: synthetic clouds of seed 0):
the config's Point-MAE run with a random mask of ``int(G * --mask_ratio)``
groups (Point-MAE's own count, ``models/Point_MAE.py:308``, not GM3D's), drawn
from a generator seeded ``--seed``; visible patches grey, rebuilt ones red.
``--heatmap`` adds ``heat_<b>.ply``: the GM3D student's predicted loss painted
on each group. As in the JAX CLI, that student is a fresh one (weights from
seed 0) and never reads ``--ckpt`` (``ROADMAP.md`` Queue 3 records it as a
fault of the reference, not followed into a repair).

``--ckpt`` is a checkpoint root of the port's pretrain CLI with
``--model_family pointmae``; a path without a checkpoint raises
``FileNotFoundError``. Without ``--ckpt`` the weights are drawn from seed 0.
Runs on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from gm3d_tpu_torch.ckpt.checkpoint import restore_raw
from gm3d_tpu_torch.cli.common import base_parser, compute_dtype, load_config, setup_mesh
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.data.datasets import SyntheticClouds, build_dataset_from_cfg
from gm3d_tpu_torch.eval.visualize import dump_loss_heatmap, dump_reconstruction
from gm3d_tpu_torch.masking import random_mask
from gm3d_tpu_torch.models import GM3DStudent
from gm3d_tpu_torch.utils import get_logger


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = base_parser("reconstruction / heatmap visualisation")
    p.add_argument("--ckpt", default=None, help="a checkpoint root of the port's CLIs")
    p.add_argument("--out_dir", default="./vis")
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--mask_ratio", type=float, default=0.6)
    p.add_argument("--heatmap", action="store_true",
                   help="also dump GM3D predicted-loss heatmaps (a fresh student, as in "
                        "the JAX CLI)")
    return p.parse_args(argv)


def build_model(args, cfg, dtype: torch.dtype, logger) -> torch.nn.Module:
    """The config's Point-MAE, from ``--ckpt`` or drawn from seed 0 (the JAX
    CLI's init key)."""
    model = build_model_from_cfg(cfg["model"], dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if args.ckpt:
        raw = restore_raw(args.ckpt)
        if raw is None:
            raise FileNotFoundError(f"no checkpoint at {args.ckpt}")
        model.load_state_dict(raw["model"], strict=True)
        logger.info(f"restored step {int(raw['step'])}")
    return model


def build_student(dtype: torch.dtype) -> GM3DStudent:
    """The heatmap's GM3D student: class defaults, weights from seed 0."""
    student = GM3DStudent(dtype=dtype)
    student.reset_parameters(torch.Generator().manual_seed(0))
    return student


def load_clouds(args, cfg, npoints: int) -> np.ndarray:
    """The first ``--num_samples`` clouds, ``(num_samples, npoints, 3)`` float32."""
    if args.synthetic:
        ds = SyntheticClouds(args.num_samples, npoints, seed=0)
    else:
        ds = build_dataset_from_cfg(cfg["dataset"]["val"])
    items = [ds[i][2] for i in range(args.num_samples)]
    pts = np.stack([x[0] if isinstance(x, tuple) else x for x in items])
    return pts[:, :npoints].astype(np.float32)


def main(argv: Optional[List[str]] = None) -> str:
    """Write the PLY files; returns ``--out_dir``."""
    args = parse_args(argv)
    dev = setup_mesh(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args)
    logger = get_logger("gm3d.vis")
    dtype = compute_dtype(args)
    pts = torch.from_numpy(load_clouds(args, cfg, cfg.get("npoints", 1024))).to(dev)

    model = build_model(args, cfg, dtype, logger).to(dev)
    # Point-MAE's own random-mask count (the visualisation path of tools/runner.py)
    num_mask = int(model.num_group * args.mask_ratio)
    mask = random_mask(torch.Generator().manual_seed(args.seed), pts.shape[0],
                       model.num_group, num_mask)
    dump_reconstruction(model, pts, mask, num_mask, args.out_dir)
    logger.info(f"wrote {pts.shape[0]} reconstruction PLYs to {args.out_dir}")

    if args.heatmap:
        dump_loss_heatmap(build_student(dtype).to(dev), pts, args.out_dir)
        logger.info("wrote loss-prediction heatmap PLYs")
    return args.out_dir


if __name__ == "__main__":
    main()

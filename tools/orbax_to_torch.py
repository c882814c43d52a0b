#!/usr/bin/env python3
"""Carry a JAX Point-MAE teacher checkpoint across to the PyTorch port.

    python tools/orbax_to_torch.py SRC_CKPT_DIR DST_CKPT_DIR [--step N]

reads the orbax checkpoint of a ``gm3d_tpu`` pretrain run (``--model_family
pointmae``: ``<output_dir>/ckpt``) with ``gm3d_tpu.ckpt.restore_raw``, maps
its ``params`` and ``batch_stats`` to a torch state dict under the
reference's names (``gm3d_tpu_torch.ckpt.torch_import.state_dict_from_flax``
with ``POINT_MAE_MAP``), and writes it as a checkpoint of the port
(``gm3d_tpu_torch.ckpt.checkpoint``) at the same step, which
``python -m gm3d_tpu_torch.cli.pretrain --teacher_ckpt DST_CKPT_DIR`` reads.

Weights only: the optimizer's moments do not cross, so a JAX run is not
resumed in the port. It needs both packages, JAX and orbax included, so it
runs where the JAX package runs, not on a machine with only the port.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import jax
import numpy as np
import torch

from gm3d_tpu.ckpt import restore_raw
from gm3d_tpu_torch.ckpt.checkpoint import save_checkpoint
from gm3d_tpu_torch.ckpt.torch_import import POINT_MAE_MAP, state_dict_from_flax


def convert(src: str, dst: str, step: Optional[int] = None) -> int:
    """Convert step ``step`` (default: the latest) of ``src``; returns it."""
    raw = restore_raw(src, step)
    if raw is None:
        raise FileNotFoundError(f"no orbax checkpoint at {src}")
    variables = {"params": raw["params"]}
    if raw.get("batch_stats") is not None:
        variables["batch_stats"] = raw["batch_stats"]
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables), POINT_MAE_MAP)
    # flax keeps no count of BN updates; the port's modules carry one
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    out_step = int(np.asarray(raw["step"]))
    if not save_checkpoint(dst, {"step": out_step, "model": sd, "ema": None,
                                 "optimizer": None}, out_step):
        raise FileExistsError(f"{dst} already holds step {out_step} or a later one")
    return out_step


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="orbax checkpoint directory of a gm3d_tpu pretrain run")
    p.add_argument("dst", help="checkpoint directory of the port to write")
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    args = p.parse_args(argv)
    step = convert(args.src, args.dst, args.step)
    print(f"wrote step {step} to {args.dst}")
    return step


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Carry a JAX checkpoint across to the PyTorch port.

    python tools/orbax_to_torch.py SRC_CKPT_DIR DST_CKPT_DIR [--step N]
        [--kind {pointmae,classifier,seg,m2ae,m2ae_classifier,m2ae_seg}]

reads the orbax checkpoint of a ``gm3d_tpu`` run (``<output_dir>/ckpt``, or a
pinned subdirectory such as ``ckpt/best``) with ``gm3d_tpu.ckpt.restore_raw``,
maps its ``params`` and ``batch_stats`` to a torch state dict
(``gm3d_tpu_torch.ckpt.torch_import.state_dict_from_flax`` with the map of
``--kind``, see :data:`MAPS`), and writes it as a checkpoint of the port
(``gm3d_tpu_torch.ckpt.checkpoint``) at the same step. The kinds:

  pointmae         the Point-MAE teacher's pretrain (``--model_family
                   pointmae``; the default), which
                   ``python -m gm3d_tpu_torch.cli.pretrain --teacher_ckpt DST`` reads
  classifier       a finetuned ``PointTransformer``
  seg              a Point-MAE part-segmentation model
  m2ae             a Point-M2AE pretrain
  m2ae_classifier  a finetuned Point-M2AE classifier
  m2ae_seg         a Point-M2AE part-segmentation model

``python -m gm3d_tpu_torch.cli.export_model --ckpt DST_CKPT_DIR`` exports any
of them, so a model trained by the JAX package is served by the port.

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
from gm3d_tpu_torch.ckpt import torch_import
from gm3d_tpu_torch.ckpt.torch_import import state_dict_from_flax

# --kind -> the name map of ckpt/torch_import.py
MAPS = {
    "pointmae": torch_import.POINT_MAE_MAP,
    "classifier": torch_import.POINT_TRANSFORMER_MAP,
    "seg": torch_import.POINT_MAE_SEG_MAP,
    "m2ae": torch_import.M2AE_MAP,
    "m2ae_classifier": torch_import.M2AE_CLASSIFIER_MAP,
    "m2ae_seg": torch_import.M2AE_SEG_MAP,
}


def convert(src: str, dst: str, step: Optional[int] = None, kind: str = "pointmae") -> int:
    """Convert step ``step`` (default: the latest) of ``src``, a checkpoint of
    a model of ``kind`` (a key of :data:`MAPS`); returns the step."""
    if kind not in MAPS:
        raise ValueError(f"unknown kind {kind!r} (expected one of {sorted(MAPS)})")
    raw = restore_raw(src, step)
    if raw is None:
        raise FileNotFoundError(f"no orbax checkpoint at {src}")
    variables = {"params": raw["params"]}
    if raw.get("batch_stats") is not None:
        variables["batch_stats"] = raw["batch_stats"]
    sd = state_dict_from_flax(jax.tree.map(np.asarray, variables), MAPS[kind])
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
    p.add_argument("src", help="orbax checkpoint directory of a gm3d_tpu run")
    p.add_argument("dst", help="checkpoint directory of the port to write")
    p.add_argument("--step", type=int, default=None, help="default: the latest")
    p.add_argument("--kind", choices=sorted(MAPS), default="pointmae",
                   help="the model the checkpoint holds, which picks the name map")
    args = p.parse_args(argv)
    step = convert(args.src, args.dst, args.step, args.kind)
    print(f"wrote step {step} to {args.dst}")
    return step


if __name__ == "__main__":
    main()

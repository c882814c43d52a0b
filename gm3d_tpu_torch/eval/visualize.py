"""Reconstruction and predicted-loss heatmap dumps as PLY files.

Port of ``gm3d_tpu/eval/visualize.py`` (reference ``tools/runner.py``
test_net and the PLY dumps of ``engine_pretrain_Classifier_SVM.py:735-827``).
Both run the model in eval mode without gradient on the points' device and
put the module's mode back after; the grouping launches the FPS and KNN
kernels on the card.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from gm3d_tpu_torch.models.pointmae import take_groups
from gm3d_tpu_torch.ops.group import group_points
from gm3d_tpu_torch.train.finetune import _eval_mode
from gm3d_tpu_torch.utils.ply import loss_heatmap_ply, reconstruction_ply


def _host(x: torch.Tensor):
    return x.to(torch.float32).cpu().numpy()


def dump_reconstruction(model: nn.Module, pts: torch.Tensor, mask: torch.Tensor,
                        num_mask: int, out_dir: str, prefix: str = "vis") -> None:
    """A masked Point-MAE forward, then one PLY a cloud
    (``<out_dir>/<prefix>_<b>.ply``): the visible patches grey, the rebuilt
    masked patches, moved to their centers, red (the
    ``Point_MAE.forward(vis=True)`` path, ``models/Point_MAE.py:428-439``)."""
    os.makedirs(out_dir, exist_ok=True)
    with _eval_mode(model):
        out = model(pts, mask.to(pts.device), num_mask)
        grouped = group_points(pts, model.num_group, model.group_size)
        vis_abs = take_groups(grouped.neighborhood_org, out["vis_idx"])  # (B, V, S, 3)
        rebuild_abs = out["rebuild"] + take_groups(grouped.center, out["mask_idx"])[:, :, None, :]
    vis_abs, rebuild_abs = _host(vis_abs), _host(rebuild_abs)
    for b in range(pts.shape[0]):
        reconstruction_ply(os.path.join(out_dir, f"{prefix}_{b}.ply"), vis_abs[b], rebuild_abs[b])


def dump_loss_heatmap(student: nn.Module, pts: torch.Tensor, out_dir: str,
                      prefix: str = "heat") -> None:
    """The GM3D student's unmasked forward, then one PLY a cloud
    (``<out_dir>/<prefix>_<b>.ply``): each group's points coloured by its
    predicted loss (the paper's geometric-complexity maps)."""
    os.makedirs(out_dir, exist_ok=True)
    mask = torch.zeros((pts.shape[0], student.num_group), dtype=torch.bool, device=pts.device)
    with _eval_mode(student):
        out = student(pts, mask, 0)
    groups, scores = _host(out["neighborhood_org"]), _host(out["loss_pred"])
    for b in range(pts.shape[0]):
        loss_heatmap_ply(os.path.join(out_dir, f"{prefix}_{b}.ply"), groups[b], scores[b])

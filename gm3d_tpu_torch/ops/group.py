"""Patchify: FPS centers -> KNN neighbourhood -> gather -> center-normalise.

Port of ``gm3d_tpu/ops/group.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gm3d_tpu_torch.ops.fps import fps_gather, fps_indices
from gm3d_tpu_torch.ops.knn import knn_indices


class Grouped(NamedTuple):
    neighborhood: torch.Tensor  # (B, G, S, 3) center-normalised
    center: torch.Tensor  # (B, G, 3)
    neighborhood_org: torch.Tensor  # (B, G, S, 3) absolute coordinates


def group_points(xyz: torch.Tensor, num_group: int, group_size: int) -> Grouped:
    """Divide each cloud into ``num_group`` patches of ``group_size`` points.

    xyz: (B, N, 3). Patch centers come from FPS; members from exact KNN
    around each center (points may repeat across patches).
    """
    center_idx = fps_indices(xyz, num_group)
    center = fps_gather(xyz, center_idx)  # (B, G, 3)
    idx = knn_indices(xyz, center, group_size)  # (B, G, S)
    batch = xyz.shape[0]
    neighborhood_org = fps_gather(xyz, idx.reshape(batch, -1))  # (B, G*S, 3)
    neighborhood_org = neighborhood_org.reshape(batch, num_group, group_size, 3)
    neighborhood = neighborhood_org - center[:, :, None, :]
    return Grouped(neighborhood, center, neighborhood_org)

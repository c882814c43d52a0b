"""Geometry ops of the port: FPS, exact KNN and grouping.

``fps_indices`` and ``knn_indices`` launch the CUDA kernels of ``csrc/`` for
CUDA tensors and take their plain PyTorch versions for CPU tensors.
"""

from gm3d_tpu_torch.ops.fps import fps, fps_gather, fps_indices, fps_indices_torch
from gm3d_tpu_torch.ops.group import Grouped, group_points
from gm3d_tpu_torch.ops.knn import knn_indices, knn_indices_torch

__all__ = [
    "fps_indices",
    "fps_indices_torch",
    "fps_gather",
    "fps",
    "knn_indices",
    "knn_indices_torch",
    "Grouped",
    "group_points",
]

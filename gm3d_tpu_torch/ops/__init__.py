"""Geometry ops of the port: FPS, exact KNN and grouping.

Importing this package registers the torch custom ops ``gm3d::fps``,
``gm3d::knn`` and ``gm3d::int8_mm`` (``torch.ops.gm3d.*``), which is all that
loading an exported serving program needs besides torch. ``fps_indices`` and
``knn_indices`` call them: the CUDA kernels of ``csrc/`` for CUDA tensors,
their plain PyTorch versions for CPU tensors.
"""

from gm3d_tpu_torch.ops.fps import fps, fps_gather, fps_indices, fps_indices_torch
from gm3d_tpu_torch.ops.group import Grouped, group_points
from gm3d_tpu_torch.ops.int8 import int8_matmul
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
    "int8_matmul",
]

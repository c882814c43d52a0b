"""PLY point-cloud export: loss-prediction heatmaps and reconstruction dumps.

Own copy of ``gm3d_tpu/utils/ply.py`` (numpy; reference
``engine_pretrain_Classifier_SVM.py:735-827`` tensors_to_ply and
``tools/runner.py`` visualisation). Coordinates are printed from numpy
``float32`` scalars (the shortest text that reads back as that float32), so
the same float32 points give the same file byte for byte; a coordinate
printed as a Python float (``tensor.item()``) would not."""

from __future__ import annotations

import numpy as np


def _colormap(values: np.ndarray) -> np.ndarray:
    """Map scalars to a blue->red heat colormap, uint8 (N, 3)."""
    v = values.astype(np.float64)
    lo, hi = v.min(), v.max()
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    r = np.clip(1.5 - np.abs(2.0 * t - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * t - 1.0), 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * t - 0.5), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """points (N, 3) float; colors (N, 3) uint8 optional."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if colors is not None:
                c = colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")


def loss_heatmap_ply(
    path: str, group_points: np.ndarray, group_scores: np.ndarray
) -> None:
    """Colour each group's points by its predicted loss (the attention-map
    visualisation of the reference): group_points (G, S, 3), scores (G,)."""
    g, s, _ = group_points.shape
    colors = np.repeat(_colormap(np.asarray(group_scores)), s, axis=0)
    write_ply(path, group_points.reshape(-1, 3), colors)


def reconstruction_ply(
    path: str,
    visible_points: np.ndarray,
    rebuilt_points: np.ndarray,
) -> None:
    """Reference vis convention (``models/Point_MAE.py:428-439``): visible
    patches in grey, rebuilt masked patches in red."""
    vis = np.asarray(visible_points).reshape(-1, 3)
    reb = np.asarray(rebuilt_points).reshape(-1, 3)
    colors = np.concatenate(
        [
            np.full((vis.shape[0], 3), 160, np.uint8),
            np.tile(np.array([[220, 60, 40]], np.uint8), (reb.shape[0], 1)),
        ]
    )
    write_ply(path, np.concatenate([vis, reb]), colors)

"""Chamfer distance with per-point granularity.

Port of ``gm3d_tpu/ops/chamfer.py`` (plain tensor code there too). Two call
conventions: a scalar loss (Point-MAE reconstruction) and a per-group matrix
(the GM3D loss matrix), so the per-point nearest-neighbour distances are
exposed and reduced outside. The same sums as the JAX package:
``a2 - 2 a.b + b2`` clamped at 0, no ``torch.cdist``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, 3) x (..., m, 3) -> (..., n, m) squared distances (fp32)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    cross = a @ b.transpose(-1, -2)
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    return (a2 - 2.0 * cross + b2).clamp_min(0.0)


def chamfer_per_point(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point squared nearest-neighbour distances.

    a: (..., n, 3), b: (..., m, 3) -> (dist_a (..., n), dist_b (..., m))."""
    d = _pairwise_sqdist(a, b)
    return d.min(dim=-1).values, d.min(dim=-2).values


def chamfer_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar Chamfer-L2 (mean of squared NN distances, both directions)."""
    da, db = chamfer_per_point(a, b)
    return da.mean() + db.mean()


def chamfer_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Scalar Chamfer-L1 (mean of euclidean NN distances, both directions)."""
    da, db = chamfer_per_point(a, b)
    eps = 1e-12
    return torch.sqrt(da + eps).mean() + torch.sqrt(db + eps).mean()


def chamfer_group(a: torch.Tensor, b: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """Per-group Chamfer: mean per-point NN distance within each leading
    index. a, b: (..., n, 3) / (..., m, 3) -> (...,)."""
    da, db = chamfer_per_point(a, b)
    if not squared:
        eps = 1e-12
        da = torch.sqrt(da + eps)
        db = torch.sqrt(db + eps)
    return da.mean(-1) + db.mean(-1)

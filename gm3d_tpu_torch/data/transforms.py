"""On-device point-cloud augmentations.

Port of ``gm3d_tpu/data/transforms.py``: vectorised equivalents of the
reference's ``datasets/data_transforms.py``. Each function takes a
``torch.Generator`` (``None``: the default generator of the points' device)
or the draws themselves, named after what they are, so that a test can feed
the JAX package's draws. A draw that is given replaces the one the function
would make; the others are still drawn, in the JAX function's order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gm3d_tpu_torch.parallel.context import draw_rows


def _uniform(generator: Optional[torch.Generator], shape, pts: torch.Tensor,
             low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """``shape`` uniform in [low, high), drawn on the generator's device and
    moved to the points' device and dtype; the first axis is the batch's
    (``draw_rows``)."""
    device = generator.device if generator is not None else pts.device
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=device), shape)
    return (u * (high - low) + low).to(device=pts.device, dtype=pts.dtype)


def _normal(generator: Optional[torch.Generator], shape, pts: torch.Tensor) -> torch.Tensor:
    device = generator.device if generator is not None else pts.device
    return draw_rows(lambda s: torch.randn(s, generator=generator, device=device),
                     shape).to(pts)


def scale_and_translate(generator: Optional[torch.Generator], pts: torch.Tensor,
                        scale_low: float = 2.0 / 3.0, scale_high: float = 3.0 / 2.0,
                        translate_range: float = 0.2,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample anisotropic scale + translate (``PointcloudScaleAndTranslate``,
    the only augmentation active in pretraining and fine-tune). ``scale`` and
    ``shift`` (batch, 1, 3), if given, replace the draws (scale first, then
    shift)."""
    batch = pts.shape[0]
    if scale is None:
        scale = _uniform(generator, (batch, 1, 3), pts, scale_low, scale_high)
    if shift is None:
        shift = _uniform(generator, (batch, 1, 3), pts, -translate_range, translate_range)
    return pts * scale.to(pts) + shift.to(pts)


def scale(generator: Optional[torch.Generator], pts: torch.Tensor,
          scale_low: float = 2.0 / 3.0, scale_high: float = 3.0 / 2.0,
          factor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample anisotropic scale only (``PointcloudScale``). ``factor``
    (batch, 1, 3) replaces the draw."""
    if factor is None:
        factor = _uniform(generator, (pts.shape[0], 1, 3), pts, scale_low, scale_high)
    return pts * factor.to(pts)


def translate(generator: Optional[torch.Generator], pts: torch.Tensor,
              translate_range: float = 0.2,
              shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample translate only (``PointcloudTranslate``). ``shift``
    (batch, 1, 3) replaces the draw."""
    if shift is None:
        shift = _uniform(generator, (pts.shape[0], 1, 3), pts, -translate_range,
                         translate_range)
    return pts + shift.to(pts)


def random_horizontal_flip(generator: Optional[torch.Generator], pts: torch.Tensor,
                           upright_axis: int = 2, p_apply: float = 0.95,
                           u_apply: Optional[torch.Tensor] = None,
                           u_flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mirror each non-upright axis about its per-sample max with prob 0.5,
    gated by a 0.95 per-sample apply prob (``RandomHorizontalFlip``).
    ``u_apply`` (batch, 1, 1) and ``u_flip`` (batch, 1, 3), uniform in
    [0, 1), replace the draws."""
    batch = pts.shape[0]
    if u_apply is None:
        u_apply = _uniform(generator, (batch, 1, 1), pts)
    if u_flip is None:
        u_flip = _uniform(generator, (batch, 1, 3), pts)
    apply = u_apply.to(pts.device) < p_apply
    flip = u_flip.to(pts.device) < 0.5
    axis_sel = torch.arange(3, device=pts.device) != upright_axis
    do_flip = apply & flip & axis_sel[None, None, :]
    coord_max = pts.amax(dim=1, keepdim=True)  # (B, 1, 3)
    return torch.where(do_flip, coord_max - pts, pts)


def rotate_z(generator: Optional[torch.Generator], pts: torch.Tensor,
             theta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random rotation about the up axis; ``theta`` (batch,) in [0, 2 pi)
    replaces the draw."""
    batch = pts.shape[0]
    if theta is None:
        theta = _uniform(generator, (batch,), pts, 0.0, 2.0 * math.pi)
    theta = theta.to(pts)
    c, s = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], dim=-1
                      ).reshape(batch, 3, 3)
    return torch.einsum("bnc,bcd->bnd", pts, rot)


def jitter(generator: Optional[torch.Generator], pts: torch.Tensor, std: float = 0.01,
           clip: float = 0.05, normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian jitter, clipped; ``normal`` (the points' shape, standard
    normal) replaces the draw."""
    if normal is None:
        normal = _normal(generator, pts.shape, pts)
    return pts + torch.clamp(std * normal.to(pts), -clip, clip)


def random_dropout(generator: Optional[torch.Generator], pts: torch.Tensor,
                   max_dropout: float = 0.875, u_ratio: Optional[torch.Tensor] = None,
                   u_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random point dropout: dropped points are replaced by the first point
    (shapes stay static). ``u_ratio`` (batch, 1) and ``u_drop`` (batch, N),
    uniform in [0, 1), replace the draws."""
    batch, num_points, _ = pts.shape
    if u_ratio is None:
        u_ratio = _uniform(generator, (batch, 1), pts)
    if u_drop is None:
        u_drop = _uniform(generator, (batch, num_points), pts)
    drop = u_drop.to(pts) < u_ratio.to(pts) * max_dropout
    return torch.where(drop[..., None], pts[:, :1, :], pts)


def separate_point_cloud(generator: Optional[torch.Generator], pts: torch.Tensor,
                         num_crop: int, direction: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Crop generator (the reference's ``seprate_point_cloud``): pick a
    random view direction per sample, remove the ``num_crop`` points nearest
    to it, return (remaining-as-input, cropped). ``direction`` (batch, 1, 3),
    standard normal and not yet normalised, replaces the draw."""
    batch = pts.shape[0]
    if direction is None:
        direction = _normal(generator, (batch, 1, 3), pts)
    direction = direction.to(pts)
    direction = direction / torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    dist = ((pts - direction) ** 2).sum(dim=-1)  # (B, N)
    order = torch.argsort(dist, dim=-1, stable=True)
    crop_idx, keep_idx = order[:, :num_crop], order[:, num_crop:]
    crop = torch.take_along_dim(pts, crop_idx[..., None], dim=1)
    keep = torch.take_along_dim(pts, keep_idx[..., None], dim=1)
    return keep, crop


def unit_sphere_normalize(pts: torch.Tensor) -> torch.Tensor:
    """Center at the centroid, scale to the unit sphere; a degenerate
    (all-identical) cloud is left centred, not divided by 0."""
    pts = pts - pts.mean(dim=-2, keepdim=True)
    radius = torch.sqrt((pts ** 2).sum(dim=-1)).amax(dim=-1)
    radius = torch.where(radius > 0, radius, torch.ones_like(radius))
    return pts / radius[..., None, None]

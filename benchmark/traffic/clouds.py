"""Surface-like point clouds from a seed, made in bulk on a device.

Each cloud is an object of two parts, as ShapeNet models are made of parts:
two superquadric surfaces (box-, cylinder-, sphere- and star-like by their
exponents) of random half-axes, each rotated at random and placed at a random
offset, with 1 % noise along each axis. Every cloud is normalised into the
unit sphere, as ``pc_normalize`` does for ShapeNet-55. Points are drawn by
uniform angles, so they crowd at edges and corners as scans do; no two points
coincide but by chance. The same seed gives the same clouds on the same
device type; a CUDA and a CPU generator give different numbers.
"""

from __future__ import annotations

import math

import torch

PARTS = 2


def _signed_pow(w: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return torch.sign(w) * w.abs().pow(e)


def _rotations(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """(n, 3, 3) rotations from normalised random quaternions."""
    q = torch.randn((n, 4), generator=gen, device=device)
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).view(n, 3, 3)


def _chunk(gen: torch.Generator, n: int, npoints: int, device) -> torch.Tensor:
    per_part = [npoints // PARTS + (i < npoints % PARTS) for i in range(PARTS)]
    parts = []
    for count in per_part:
        axes = 0.25 + 0.75 * torch.rand((n, 1, 3), generator=gen, device=device)
        exps = 0.25 + 1.75 * torch.rand((n, 1, 2), generator=gen, device=device)
        offset = 0.6 * (torch.rand((n, 1, 3), generator=gen, device=device) - 0.5)
        u = (torch.rand((n, count), generator=gen, device=device) - 0.5) * math.pi
        v = (torch.rand((n, count), generator=gen, device=device) * 2.0 - 1.0) * math.pi
        e1, e2 = exps[..., 0], exps[..., 1]
        cu, su = _signed_pow(torch.cos(u), e1), _signed_pow(torch.sin(u), e1)
        cv, sv = _signed_pow(torch.cos(v), e2), _signed_pow(torch.sin(v), e2)
        pts = torch.stack([cu * cv, cu * sv, su], dim=-1) * axes
        # the rotation as sums of products: no matrix unit, whose precision is a setting
        rot = _rotations(gen, n, device)
        pts = (pts[:, :, None, :] * rot[:, None, :, :]).sum(-1) + offset
        parts.append(pts)
    pts = torch.cat(parts, dim=1)
    pts = pts + 0.01 * torch.randn(pts.shape, generator=gen, device=device)
    pts = pts - pts.mean(dim=1, keepdim=True)
    return pts / pts.norm(dim=-1).amax(dim=1).clamp_min(1e-12)[:, None, None]


def make_clouds(seed: int, count: int, npoints: int, device="cpu",
                chunk: int = 4096) -> torch.Tensor:
    """(count, npoints, 3) float32 clouds on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    out = [_chunk(gen, min(chunk, count - start), npoints, device)
           for start in range(0, count, chunk)]
    return torch.cat(out, dim=0).contiguous()

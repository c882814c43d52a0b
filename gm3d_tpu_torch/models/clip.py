"""CLIP vision tower: the ``--learn_feature_loss clip`` distillation teacher.

Port of ``gm3d_tpu/models/clip.py``. The tower is the reference's CLIP
``VisionTransformer`` under its parameter names (``conv1``,
``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}``, ``ln_post``, ``proj``), so the
``visual.*`` part of a CLIP state dict loads with ``strict=True``.
``features`` is the engine's ``forward_features_clip``: ln_post over ALL
tokens, projected, cls token dropped -> (B, grid^2, output_dim).

Point clouds reach the tower as 3-channel orthographic depth images rendered
on the device (:func:`render_depth_views`, channel-first), and each FPS
group's target is the patch token its center projects into
(:func:`clip_group_targets`).

Compute dtype as in ``models/blocks.py``: parameters fp32, cast where used;
LayerNorms in fp32; the attention softmax in fp32. The tower's attention is
plain tensor code (its 65 tokens at the default size are more than the fused
kernels hold), as it is plain XLA in the JAX package. ``conv1``'s product
follows ``torch.backends.cudnn.allow_tf32``, which the pretrain CLI turns off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gm3d_tpu_torch.models.blocks import Dense, LayerNorm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU."""
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (a fused in-projection with
    bias, ``out_proj``) and its function, batch first."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.heads, self.compute_dtype = width, heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Dense(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, _ = x.shape
        dt, head_dim = self.compute_dtype, self.width // self.heads
        qkv = F.linear(x.to(dt), self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = qkv.reshape(batch, seq, 3, self.heads, head_dim).permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q, k.transpose(-1, -2)) * head_dim ** -0.5
        attn = torch.softmax(attn.to(torch.float32), dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(batch, seq, self.width)
        return self.out_proj(out)


class CLIPMlp(nn.Module):
    """``c_fc``, QuickGELU, ``c_proj`` (the reference's ``mlp`` Sequential)."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c_fc = Dense(width, 4 * width, dtype=dtype)
        self.c_proj = Dense(4 * width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class CLIPBlock(nn.Module):
    """``ResidualAttentionBlock``: pre-norm attention, pre-norm MLP."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(width, dtype=dtype)
        self.attn = CLIPAttention(width, heads, dtype=dtype)
        self.ln_2 = LayerNorm(width, dtype=dtype)
        self.mlp = CLIPMlp(width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class CLIPTransformer(nn.Module):
    """The block stack, under the reference's ``transformer.resblocks``."""

    def __init__(self, width: int, layers: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPBlock(width, heads, dtype) for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class CLIPVisionTower(nn.Module):
    """CLIP ViT vision tower over channel-first images (B, 3, R, R)."""

    def __init__(self, input_resolution: int = 32, patch_size: int = 4, width: int = 256,
                 layers: int = 6, heads: int = 8, output_dim: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution, self.patch_size = input_resolution, patch_size
        self.width, self.layers, self.heads = width, layers, heads
        self.output_dim, self.compute_dtype = output_dim, dtype
        self.grid = input_resolution // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(self.grid ** 2 + 1, width))
        self.ln_pre = LayerNorm(width, dtype=dtype)
        self.transformer = CLIPTransformer(width, layers, heads, dtype)
        self.ln_post = LayerNorm(width, dtype=dtype)
        self.proj = nn.Parameter(torch.empty(width, output_dim))
        self.reset_parameters()

    @property
    def config(self) -> dict:
        return dict(input_resolution=self.input_resolution, patch_size=self.patch_size,
                    width=self.width, layers=self.layers, heads=self.heads,
                    output_dim=self.output_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX tower's init laws: the three raw parameters normal with std
        ``width ** -0.5``, every kernel lecun-normal (std ``fan_in ** -0.5``),
        zero biases, unit LayerNorms; drawn from ``generator``."""
        scale = self.width ** -0.5
        with torch.no_grad():
            for p in (self.class_embedding, self.positional_embedding, self.proj):
                p.normal_(0.0, scale, generator=generator)
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, (3 * self.patch_size ** 2) ** -0.5, generator=generator)
                elif isinstance(m, CLIPAttention):
                    m.in_proj_weight.normal_(0.0, m.width ** -0.5, generator=generator)
                    m.in_proj_bias.zero_()
                elif isinstance(m, nn.Linear):
                    m.weight.normal_(0.0, m.in_features ** -0.5, generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    def _tokens(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.conv2d(images.to(dt), self.conv1.weight.to(dt), stride=self.patch_size)
        batch = x.shape[0]
        x = x.reshape(batch, self.width, -1).transpose(1, 2)  # (B, grid^2, width), row-major
        cls = self.class_embedding.to(dt).expand(batch, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        return self.transformer(self.ln_pre(x))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """The standard CLIP forward: the pooled cls embedding (B, output_dim)."""
        x = self.ln_post(self._tokens(images)[:, 0, :])
        return x @ self.proj.to(x.dtype)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """``forward_features_clip``: ln_post over all tokens, projected, cls
        dropped -> (B, grid^2, output_dim)."""
        x = self.ln_post(self._tokens(images))
        return (x @ self.proj.to(x.dtype))[:, 1:, :]


def render_depth_views(pts: torch.Tensor, resolution: int) -> torch.Tensor:
    """Orthographic max-depth splats on the device, one channel per axis view.

    pts: (B, N, 3), about unit-sphere normalised. Returns (B, 3, R, R):
    channel c is the view along axis c, each pixel the largest ``1 - depth``
    of the points that fall in it (0 where none does). Max is order-free, so
    every device gives the same image."""
    batch, num_points, _ = pts.shape
    coords = ((pts + 1.0) * 0.5).clamp(0.0, 1.0)  # [0, 1]^3
    base = (torch.arange(batch, device=pts.device) * resolution * resolution)[:, None]
    channels = []
    for u, v, d in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        # the int32 casts of non-negative values truncate, as astype(int32) does
        xi = (coords[..., u] * (resolution - 1)).to(torch.int32).clamp(0, resolution - 1)
        yi = (coords[..., v] * (resolution - 1)).to(torch.int32).clamp(0, resolution - 1)
        depth = 1.0 - coords[..., d]  # nearer to the camera = brighter
        flat = (base + yi.to(torch.int64) * resolution + xi.to(torch.int64)).reshape(-1)
        img = torch.zeros(batch * resolution * resolution, dtype=pts.dtype, device=pts.device)
        img.scatter_reduce_(0, flat, depth.reshape(-1), "amax", include_self=True)
        channels.append(img.reshape(batch, resolution, resolution))
    return torch.stack(channels, dim=1)


# the fp32 clamp below 1 of the centers' image-plane coordinates
_BELOW_ONE = 1.0 - 1e-6


def center_patches(centers: torch.Tensor, grid: int) -> torch.Tensor:
    """The patch (row-major on the first view's image plane, ``grid`` x
    ``grid``) that each center (B, G, 3) falls into: (B, G) int64."""
    below_one = torch.tensor(_BELOW_ONE, dtype=torch.float32, device=centers.device)
    cxy = torch.minimum(((centers[..., :2] + 1.0) * 0.5).clamp_min(0.0), below_one)
    xi = (cxy[..., 0] * grid).to(torch.int32)
    yi = (cxy[..., 1] * grid).to(torch.int32)
    return (yi * grid + xi).to(torch.int64)


@torch.no_grad()
def clip_group_targets(tower: CLIPVisionTower, pts: torch.Tensor,
                       centers: torch.Tensor) -> torch.Tensor:
    """Per-group feature targets from the frozen CLIP tower, without gradient.

    Renders the full cloud ``pts`` (B, N, 3), takes the (B, grid^2, D) patch
    tokens, and gives each group the token of the patch its center (B, G, 3)
    falls into (:func:`center_patches`). Returns (B, G, output_dim)."""
    tokens = tower.features(render_depth_views(pts, tower.input_resolution))
    patch = center_patches(centers, tower.grid)
    return torch.gather(tokens, 1, patch[..., None].expand(-1, -1, tokens.shape[-1]))

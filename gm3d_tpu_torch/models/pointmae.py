"""Point-MAE: masked-autoencoder pretraining backbone.

Port of ``gm3d_tpu/models/pointmae.py``: the legacy masked-reconstruction
model and, with an all-False mask, the frozen complete-to-partial distillation
teacher of the GM3D pretrain step (``encode_features`` + ``decode_replay``).

Mask GENERATION lives outside the model (``gm3d_tpu_torch.masking``): the
model receives a boolean mask plus the masked count. Train / eval mode is the
module's own (``.train()`` / ``.eval()``), where the JAX modules take
``deterministic``; ``generator`` feeds stochastic depth.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from gm3d_tpu_torch.models.blocks import (
    LayerNorm,
    PatchEncoder,
    PointConv,
    PosEmbedMLP,
    TransformerDecoder,
    TransformerEncoder,
    init_weights,
    trunc_normal_,
)
from gm3d_tpu_torch.ops.group import Grouped, group_points


def mask_split_indices(mask: torch.Tensor, num_mask: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visible / masked group indices, each in original group order.

    mask: (B, G) bool with exactly ``num_mask`` True per row. A stable
    argsort reproduces ``tokens[~mask].reshape(B, -1, C)`` with static
    shapes."""
    num_groups = mask.shape[-1]
    order = torch.argsort(mask.to(torch.int32), dim=-1, stable=True)
    return order[:, : num_groups - num_mask], order[:, num_groups - num_mask:]


def take_groups(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the group axis: (B, G, ...) x (B, K) -> (B, K, ...)."""
    index = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(-1, -1, *x.shape[2:])
    return torch.gather(x, 1, index)


class MaskTransformer(nn.Module):
    """Patch embed + ViT encoder over VISIBLE groups only.

    ``norm_name``: the reference calls the final LayerNorm ``norm`` in the
    Point-MAE teacher and ``norm_p`` in the GM3D student; the attribute takes
    that name so state dicts match."""

    def __init__(self, trans_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 drop_path_rate: float = 0.1, encoder_dims: int = 384,
                 dtype: torch.dtype = torch.float32, norm_name: str = "norm"):
        super().__init__()
        if norm_name not in ("norm", "norm_p"):
            raise ValueError(f"norm_name must be 'norm' or 'norm_p', got {norm_name!r}")
        self.norm_name = norm_name
        self.encoder = PatchEncoder(encoder_dims, dtype=dtype)
        self.pos_embed = PosEmbedMLP(trans_dim, dtype=dtype)
        self.blocks = TransformerEncoder(trans_dim, depth, num_heads, drop_path_rate,
                                         dtype=dtype)
        setattr(self, norm_name, LayerNorm(trans_dim, dtype=dtype))

    def forward(self, neighborhood: torch.Tensor, center: torch.Tensor,
                mask: Optional[torch.Tensor], num_mask: int,
                tokens: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``tokens`` (B, G, C) optionally bypasses the patch embed: the train
        step feeds the fused patch embed's output here for the grad-free EMA
        and teacher passes (``ops/patch_embed.py``)."""
        if tokens is None:
            tokens = self.encoder(neighborhood)  # (B, G, C)
        if num_mask:
            vis_idx, _ = mask_split_indices(mask, num_mask)
            tokens = take_groups(tokens, vis_idx)
            center = take_groups(center, vis_idx)
        pos = self.pos_embed(center)
        return getattr(self, self.norm_name)(self.blocks(tokens, pos, None, generator))


class PointMAE(nn.Module):
    """Point-MAE pretrain model (registry name ``Point_MAE``): the legacy
    pretrain path and, with ``mask`` all-False, the frozen distillation
    teacher."""

    def __init__(self, trans_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 decoder_depth: int = 4, decoder_num_heads: int = 6,
                 group_size: int = 32, num_group: int = 64,
                 drop_path_rate: float = 0.1, encoder_dims: int = 384,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trans_dim, self.num_group, self.group_size = trans_dim, num_group, group_size
        self.MAE_encoder = MaskTransformer(trans_dim, depth, num_heads, drop_path_rate,
                                           encoder_dims, dtype=dtype, norm_name="norm")
        self.decoder_pos_embed = PosEmbedMLP(trans_dim, dtype=dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.MAE_decoder = TransformerDecoder(trans_dim, decoder_depth, decoder_num_heads,
                                              drop_path_rate, dtype=dtype)
        # prediction head: Conv1d(trans_dim -> 3*group_size, k=1)
        self.increase_dim = nn.Sequential(PointConv(trans_dim, 3 * group_size, dtype))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_weights(self, generator)
        trunc_normal_(self.mask_token, generator)

    def group(self, pts: torch.Tensor) -> Grouped:
        return group_points(pts, self.num_group, self.group_size)

    def encode_features(self, pts: torch.Tensor, grouped: Optional[Grouped] = None,
                        tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder-only forward over all groups (the SVM feature path)."""
        if grouped is None:
            grouped = self.group(pts)
        return self.MAE_encoder(grouped.neighborhood, grouped.center, None, 0, tokens=tokens)

    def encode(self, pts: torch.Tensor, mask: torch.Tensor, num_mask: int,
               generator: Optional[torch.Generator] = None):
        grouped = self.group(pts)
        x_vis = self.MAE_encoder(grouped.neighborhood, grouped.center, mask, num_mask,
                                 generator=generator)
        return x_vis, grouped

    def forward(self, pts: torch.Tensor, mask: torch.Tensor, num_mask: int,
                generator: Optional[torch.Generator] = None) -> dict:
        """Masked reconstruction forward. Returns the rebuilt and the
        ground-truth masked patches; the Chamfer loss is the train step's."""
        x_vis, grouped = self.encode(pts, mask, num_mask, generator)
        batch = pts.shape[0]
        vis_idx, mask_idx = mask_split_indices(mask, num_mask)
        pos_vis = self.decoder_pos_embed(take_groups(grouped.center, vis_idx))
        if num_mask:
            pos_mask = self.decoder_pos_embed(take_groups(grouped.center, mask_idx))
            mask_tokens = self.mask_token.to(x_vis.dtype).expand(batch, num_mask, -1)
            x_full = torch.cat([x_vis, mask_tokens], dim=1)
            pos_full = torch.cat([pos_vis, pos_mask], dim=1)
            x_rec = self.MAE_decoder(x_full, pos_full, return_tokens=num_mask,
                                     generator=generator)
            rebuild = self.increase_dim(x_rec).reshape(batch, num_mask, self.group_size, 3)
            gt = take_groups(grouped.neighborhood, mask_idx)
        else:
            # mask_ratio 0 (the teacher): decode and rebuild ALL groups
            x_rec = self.MAE_decoder(x_vis, pos_vis, return_tokens=0, generator=generator)
            rebuild = self.increase_dim(x_rec).reshape(
                batch, self.num_group, self.group_size, 3)
            gt = grouped.neighborhood
        return {"rebuild": rebuild, "gt": gt, "center": grouped.center,
                "mask_idx": mask_idx, "vis_idx": vis_idx, "x_vis": x_vis}

    def decode_replay(self, tokens: torch.Tensor, centers_sel: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Run the decoder + head on an arbitrary token sequence positioned
        at ``centers_sel`` (the complete-to-partial distillation replay).
        Returns per-token rebuilt patches (B, T, S, 3)."""
        pos = self.decoder_pos_embed(centers_sel)
        x_rec = self.MAE_decoder(tokens, pos, return_tokens=0, generator=generator)
        batch, seq = x_rec.shape[0], x_rec.shape[1]
        return self.increase_dim(x_rec).reshape(batch, seq, self.group_size, 3)

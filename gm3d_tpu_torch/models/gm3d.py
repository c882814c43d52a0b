"""GM3D student: masked autoencoder with dual decoders + per-group loss predictor.

Port of ``gm3d_tpu/models/gm3d.py``. Reference behaviours preserved:

  - 12-layer MaskTransformer encoder over visible groups;
  - reconstruction decoder (depth 4) and loss-prediction decoder (depth 12 in
    feature mode, 4 in usual mode), each fed ``[x_vis, mask_tokens]`` with
    per-group-center pos embeds, norming and returning the FULL sequence;
  - separate learnable mask tokens for the two decoders, optionally shared;
  - heads: feature head Conv1d 384->1024(BN, LeakyReLU)->384, coordinate head
    Conv1d 384->3*group_size;
  - ``loss_pred`` = feature-head output meaned over channels;
  - ``pix_pred`` = decoder features (feature mode) or rebuilt coordinates
    (usual mode).

Sub-modules carry the reference's names, so that a whole checkpoint loads
with ``strict=True``. Train / eval mode is the module's own.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gm3d_tpu_torch.models.blocks import (
    PointConv,
    PosEmbedMLP,
    TorchBatchNorm,
    TransformerDecoder,
    init_weights,
)
from gm3d_tpu_torch.models.pointmae import MaskTransformer, mask_split_indices, take_groups
from gm3d_tpu_torch.ops.group import Grouped, group_points


class GM3DStudent(nn.Module):
    """GM3D student MAE. Hyperparameters default to the reference's
    hard-coded class values."""

    def __init__(self, trans_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 decoder_depth: int = 4, decoder_num_heads: int = 6,
                 group_size: int = 32, num_group: int = 64,
                 drop_path_rate: float = 0.1, encoder_dims: int = 384,
                 mode: str = "feature", shared_pos_embed: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("feature", "usual"):
            raise ValueError(f"mode must be 'feature' or 'usual', got {mode!r}")
        self.trans_dim, self.num_group, self.group_size = trans_dim, num_group, group_size
        self.mode = mode
        # the OLDER student variant has no decoder pos-embed MLP: the
        # encoder's ``pos_embed`` also positions the decoder tokens
        self.shared_pos_embed = shared_pos_embed
        self.compute_dtype = dtype
        self.MAE_encoder = MaskTransformer(trans_dim, depth, num_heads, drop_path_rate,
                                           encoder_dims, dtype=dtype, norm_name="norm_p")
        self.MAE_decoder = TransformerDecoder(trans_dim, decoder_depth, decoder_num_heads,
                                              drop_path_rate, dtype=dtype)
        loss_pred_depth = depth if mode == "feature" else decoder_depth
        self.MAE_decoder_loss_pred = TransformerDecoder(
            trans_dim, loss_pred_depth, decoder_num_heads, drop_path_rate, dtype=dtype)
        if not shared_pos_embed:
            self.decoder_pos_embed = PosEmbedMLP(trans_dim, dtype=dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.mask_token_loss_pred = nn.Parameter(torch.zeros(1, 1, trans_dim))
        # feature head: Conv1d(384->1024) BN LeakyReLU(0.2) Conv1d(1024->384)
        self.increase_dim_2 = nn.Sequential(
            PointConv(trans_dim, 1024, dtype), TorchBatchNorm(1024, dtype),
            nn.LeakyReLU(0.2), PointConv(1024, trans_dim, dtype))
        # coordinate head: Conv1d(384 -> 3*group_size)
        self.increase_dim_just_network_without_feature = nn.Sequential(
            PointConv(trans_dim, 3 * group_size, dtype))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_weights(self, generator)  # the two mask tokens start at zero

    def group(self, pts: torch.Tensor) -> Grouped:
        return group_points(pts, self.num_group, self.group_size)

    def encode_features(self, pts: torch.Tensor) -> torch.Tensor:
        """Encoder-only forward over all groups (SVM features)."""
        grouped = self.group(pts)
        return self.MAE_encoder(grouped.neighborhood, grouped.center, None, 0)

    def forward(self, pts: torch.Tensor, mask: torch.Tensor, num_mask: int,
                shared_learnable_tokens: bool = False,
                grouped: Optional[Grouped] = None,
                detach_loss_pred_branch: bool = False,
                tokens: Optional[torch.Tensor] = None,
                loss_pred_only: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        """Full student forward.

        With ``num_mask == 0`` this is the EMA's unmasked pass: no mask tokens
        are appended, and ``loss_pred`` covers all groups in original order,
        which is what ``geometric_mask`` consumes.
        ``grouped`` lets the train step share ONE FPS/KNN grouping across the
        EMA, student and teacher passes; ``tokens`` bypasses the patch embed.
        ``loss_pred_only=True`` skips the reconstruction decoder and the
        coordinate head (``pix_pred``/``rebuild_points`` = None).
        ``detach_loss_pred_branch`` detaches the encoder features before the
        loss-prediction decoder (the separated-optimizer semantics).
        Returns a dict mirroring the reference ``out`` keys.
        """
        batch = pts.shape[0]
        if grouped is None:
            grouped = self.group(pts)
        x_vis = self.MAE_encoder(grouped.neighborhood, grouped.center, mask, num_mask,
                                 tokens=tokens, generator=generator)

        vis_idx, mask_idx = mask_split_indices(mask, num_mask)
        x_vis_lp = x_vis.detach() if detach_loss_pred_branch else x_vis
        dec_pos = self.MAE_encoder.pos_embed if self.shared_pos_embed else self.decoder_pos_embed
        pos_vis = dec_pos(take_groups(grouped.center, vis_idx))
        if num_mask:
            pos_mask = dec_pos(take_groups(grouped.center, mask_idx))
            pos_full = torch.cat([pos_vis, pos_mask], dim=1)
            dt = self.compute_dtype
            mask_tok = self.mask_token.to(dt).expand(batch, num_mask, -1)
            x_full = torch.cat([x_vis, mask_tok], dim=1)
            if shared_learnable_tokens:
                x_loss = torch.cat([x_vis_lp, mask_tok], dim=1)
            else:
                mask_tok_lp = self.mask_token_loss_pred.to(dt).expand(batch, num_mask, -1)
                x_loss = torch.cat([x_vis_lp, mask_tok_lp], dim=1)
        else:
            x_full, x_loss, pos_full = x_vis, x_vis_lp, pos_vis

        # reconstruction decoder: full normed sequence; pix_pred = features
        if loss_pred_only:
            rebuild_points = pix_pred = None
        else:
            x_rec = self.MAE_decoder(x_full, pos_full, return_tokens=0, generator=generator)
            rebuild_points = self.increase_dim_just_network_without_feature(x_rec)  # (B, L, 3S)
            pix_pred = x_rec if self.mode == "feature" else rebuild_points

        # loss-prediction decoder + feature head, meaned over channels
        x_lp = self.MAE_decoder_loss_pred(x_loss, pos_full, return_tokens=0,
                                          generator=generator)
        loss_pred = self.increase_dim_2(x_lp).to(torch.float32).mean(dim=-1)  # (B, L)

        return {
            "pix_pred": pix_pred,
            "rebuild_points": rebuild_points,
            "mask": mask,
            "mask_num": num_mask,
            "features": x_vis,
            "loss_pred": loss_pred,
            "neighborhood": grouped.neighborhood,
            "neighborhood_org": grouped.neighborhood_org,
            "center": grouped.center,
            "vis_idx": vis_idx,
            "mask_idx": mask_idx,
        }

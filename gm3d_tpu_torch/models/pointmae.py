"""Point-MAE: masked-autoencoder pretraining backbone.

Port of ``gm3d_tpu/models/pointmae.py``, as far as the frozen featurizer of
the serving path needs it: ``PointMAE`` declares every sub-module (so that a
whole checkpoint loads with ``strict=True``) but implements ``group`` and
``encode_features`` only. The masked reconstruction forward and the
distillation replay arrive with the pretrain slice.
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
                tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``tokens`` (B, G, C) optionally bypasses the patch embed."""
        if tokens is None:
            tokens = self.encoder(neighborhood)  # (B, G, C)
        if num_mask:
            vis_idx, _ = mask_split_indices(mask, num_mask)
            tokens = take_groups(tokens, vis_idx)
            center = take_groups(center, vis_idx)
        pos = self.pos_embed(center)
        return getattr(self, self.norm_name)(self.blocks(tokens, pos))


class PointMAE(nn.Module):
    """Point-MAE pretrain model (registry name ``Point_MAE``): here the frozen
    featurizer; see the module docstring for what waits."""

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

    def forward(self, pts, mask, num_mask: int):
        raise NotImplementedError(
            "PointMAE.forward (masked reconstruction) is ported with the "
            "pretrain slice; this slice has group() and encode_features()")

    def decode_replay(self, tokens, centers_sel):
        raise NotImplementedError(
            "PointMAE.decode_replay (distillation replay) is ported with the "
            "pretrain slice; this slice has group() and encode_features()")

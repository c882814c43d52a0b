"""PointTransformer fine-tune classifier + pretrain-time Classifier probe.

Port of ``gm3d_tpu/models/point_transformer.py``. Parameter names are the
reference's (``cls_head_finetune.{0,1,4,5,8}``, ``norm_p``, ``cls_token``).
"""

from __future__ import annotations

import torch
from torch import nn

from gm3d_tpu_torch.models.blocks import (
    Dense,
    LayerNorm,
    PatchEncoder,
    PosEmbedMLP,
    TorchBatchNorm,
    TransformerEncoder,
    init_weights,
    trunc_normal_,
)
from gm3d_tpu_torch.ops.group import group_points


class ClsHead(nn.Sequential):
    """Linear-BN-ReLU-Dropout x2 -> logits. ``dropout`` defaults to the
    reference's hardcoded 0.5."""

    def __init__(self, in_dim: int, cls_dim: int, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            Dense(in_dim, 256, dtype=dtype), TorchBatchNorm(256, dtype), nn.ReLU(),
            nn.Dropout(dropout),
            Dense(256, 256, dtype=dtype), TorchBatchNorm(256, dtype), nn.ReLU(),
            nn.Dropout(dropout),
            Dense(256, cls_dim, dtype=dtype))

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        """``dropout_masks``: two boolean keep masks (B, 256), one for each
        dropout, used in train mode in place of the module's own draws (a
        kept unit is scaled by 1 / (1 - p), as ``flax.linen.Dropout`` does)."""
        if dropout_masks is None or not self.training:
            return super().forward(x)
        masks = iter(dropout_masks)
        for layer in self:
            if isinstance(layer, nn.Dropout):
                x = torch.where(next(masks), x / (1.0 - layer.p), 0.0)
            else:
                x = layer(x)
        return x


class PointTransformer(nn.Module):
    """Classification fine-tune model: FPS+KNN group -> patch embed -> cls
    token + encoder -> concat[cls, max-pool] -> MLP head."""

    def __init__(self, trans_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 cls_dim: int = 40, group_size: int = 32, num_group: int = 64,
                 encoder_dims: int = 384, drop_path_rate: float = 0.1,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trans_dim, self.num_group, self.group_size = trans_dim, num_group, group_size
        self.cls_dim, self.compute_dtype = cls_dim, dtype
        self.encoder = PatchEncoder(encoder_dims, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.pos_embed = PosEmbedMLP(trans_dim, dtype=dtype)
        self.blocks = TransformerEncoder(trans_dim, depth, num_heads, drop_path_rate,
                                         dtype=dtype)
        self.norm_p = LayerNorm(trans_dim, dtype=dtype)
        self.cls_head_finetune = ClsHead(trans_dim * 2, cls_dim, dropout, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_weights(self, generator)
        trunc_normal_(self.cls_token, generator)
        trunc_normal_(self.cls_pos, generator)

    def drop_path_encoders(self) -> tuple:
        """The block stacks whose stochastic depth a train-mode forward draws,
        in its order (``blocks.draw_depth_masks``)."""
        return (self.blocks,)

    def features(self, pts: torch.Tensor, generator: torch.Generator | None = None,
                 depth_masks: tuple | None = None) -> torch.Tensor:
        """Token sequence [cls, groups...] after the encoder stack;
        ``generator`` draws the blocks' stochastic depth in train mode, or
        ``depth_masks`` (``draw_depth_masks`` over ``drop_path_encoders()``)
        hold it."""
        grouped = group_points(pts, self.num_group, self.group_size)
        tokens = self.encoder(grouped.neighborhood)
        batch, dt = tokens.shape[0], self.compute_dtype
        cls_tok = self.cls_token.to(dt).expand(batch, -1, -1)
        cls_pos = self.cls_pos.to(dt).expand(batch, -1, -1)
        pos = torch.cat([cls_pos, self.pos_embed(grouped.center)], dim=1)
        x = torch.cat([cls_tok, tokens], dim=1)
        blocks_masks = None if depth_masks is None else depth_masks[0]
        return self.norm_p(self.blocks(x, pos, generator=generator, depth_masks=blocks_masks))

    def forward(self, pts: torch.Tensor, dropout_masks=None,
                generator: torch.Generator | None = None,
                depth_masks: tuple | None = None) -> torch.Tensor:
        """Logits. In train mode ``dropout_masks`` (the head's two keep masks,
        ``ClsHead.forward``) replace the head's dropout draws, and
        ``generator`` draws stochastic depth, or ``depth_masks`` hold it."""
        x = self.features(pts, generator, depth_masks)
        concat_f = torch.cat([x[:, 0], x[:, 1:].max(dim=1).values], dim=-1)
        return self.cls_head_finetune(concat_f, dropout_masks)


class Classifier(nn.Module):
    """Pretrain-time supervised probe on encoder features:
    LN -> mean+max pool -> MLP(dim->256->256->cls_dim)."""

    def __init__(self, dim: int = 384, cls_dim: int = 40,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = LayerNorm(dim, dtype=dtype)
        self.head = ClsHead(dim, cls_dim, dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax's defaults, as the JAX CLI initialises it: each dense kernel
        LeCun normal (truncated at two deviations, variance 1 / fan-in), zero
        biases, the norms at one and zero."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                # flax's truncated normal keeps the variance: the stddev is raised
                std = (1.0 / m.in_features) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, feats: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        x = self.norm(feats)
        return self.head(x.mean(dim=1) + x.max(dim=1).values, dropout_masks)

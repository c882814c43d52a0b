"""ShapeNetPart part-segmentation model.

Port of ``gm3d_tpu/models/segmentation.py::PointMAESeg`` (registry name
``PointTransformerSeg``): the Point-MAE encoder with feature taps after the
blocks of ``feature_blocks``, inverse-distance feature propagation from the
group centers to every point, and a per-point head over 50 part labels
conditioned on the 16-way object category.

Parameter names: the encoder, positional embedding and blocks are named as
``PointTransformer`` names them (``encoder.*``, ``pos_embed.*``,
``blocks.blocks.{i}.*``), so that a pretrain checkpoint of the port overlays
onto them without renaming; the head's modules carry the flax names
(``label_embed``, ``prop_proj``, ``head_fc1``, ``head_bn1``, ``head_fc2``,
``head_bn2``, ``head_out``). The JAX module declares a final LayerNorm that
it never calls, so its tree holds no such parameters, and neither does this
module: the taps go into the head unnormalised, as there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gm3d_tpu_torch.models.blocks import (
    Dense,
    PatchEncoder,
    PosEmbedMLP,
    TorchBatchNorm,
    TransformerEncoder,
    init_weights,
)
from gm3d_tpu_torch.ops.group import group_points
from gm3d_tpu_torch.ops.knn import knn_indices

HEAD_WIDTH = 512  # the width of the head's first layer, where its dropout acts


def propagate_features(points: torch.Tensor, centers: torch.Tensor,
                       center_feats: torch.Tensor, k: int = 3) -> torch.Tensor:
    """PointNet++ feature propagation: inverse-distance-weighted interpolation
    of center features onto every point. (B, N, 3), (B, G, 3), (B, G, C) ->
    (B, N, C).

    The k nearest centers of each point come from ``ops.knn.knn_indices``
    (the KNN kernel for CUDA tensors) with their squared distances
    ``q2 - 2 q.r + r2``, the JAX package's formula. For a point that is
    itself a center that is exactly 0 here (the cross term is summed in the
    order of the squares), a rounding residue in the JAX function's
    ``einsum``; both are floored at 1e-10, and the point's own center takes
    a normalised weight of about 1 either way."""
    dist, idx = knn_indices(centers, points, k, return_dist=True)  # (B, N, k)
    w = 1.0 / torch.clamp(dist, min=1e-10)
    w = w / w.sum(dim=-1, keepdim=True)
    batch, num_points, _ = idx.shape
    gathered = torch.gather(
        center_feats, 1,
        idx.reshape(batch, -1, 1).long().expand(-1, -1, center_feats.shape[-1]),
    ).reshape(batch, num_points, k, -1)
    # fp32 weights: a bf16 tap is promoted, as in the JAX function
    return (gathered * w[..., None]).sum(dim=2)


class PointMAESeg(nn.Module):
    """Part-segmentation model: FPS+KNN group -> patch embed -> encoder with
    taps -> [propagated taps, pooled taps, category embedding, xyz] per
    point -> Linear-BN-ReLU-Dropout-Linear-BN-ReLU-Linear."""

    def __init__(self, trans_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 group_size: int = 32, num_group: int = 128, encoder_dims: int = 384,
                 drop_path_rate: float = 0.1, num_classes: int = 16, num_parts: int = 50,
                 feature_blocks: Sequence[int] = (3, 7, 11), dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trans_dim, self.num_group, self.group_size = trans_dim, num_group, group_size
        self.num_classes, self.num_parts = num_classes, num_parts
        self.feature_blocks = tuple(feature_blocks)
        self.compute_dtype = dtype
        self.encoder = PatchEncoder(encoder_dims, dtype=dtype)
        self.pos_embed = PosEmbedMLP(trans_dim, dtype=dtype)
        self.blocks = TransformerEncoder(trans_dim, depth, num_heads, drop_path_rate,
                                         dtype=dtype)
        tap_dim = trans_dim * len(self.feature_blocks)
        self.label_embed = Dense(num_classes, 64, dtype=dtype)
        self.prop_proj = Dense(tap_dim, 512, dtype=dtype)
        self.head_fc1 = Dense(512 + 2 * tap_dim + 64 + 3, HEAD_WIDTH, dtype=dtype)
        self.head_bn1 = TorchBatchNorm(HEAD_WIDTH, dtype)
        self.head_fc2 = Dense(HEAD_WIDTH, 256, dtype=dtype)
        self.head_bn2 = TorchBatchNorm(256, dtype)
        self.head_out = Dense(256, num_parts, dtype=dtype)
        self.dropout = nn.Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_weights(self, generator)

    def forward(self, pts: torch.Tensor, cls_label: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """pts (B, N, 3); cls_label (B,) object category -> per-point part
        logits (B, N, num_parts). In train mode ``dropout_mask``, a boolean
        keep mask (B, N, 512), replaces the head's dropout draw (a kept unit
        is scaled by 1 / (1 - p), as ``flax.linen.Dropout`` does), and
        ``generator`` draws stochastic depth."""
        dt = self.compute_dtype
        grouped = group_points(pts, self.num_group, self.group_size)
        x = self.encoder(grouped.neighborhood)
        pos = self.pos_embed(grouped.center)
        taps = []
        for i, block in enumerate(self.blocks.blocks):
            x = block(x + pos, None, generator)
            if i in self.feature_blocks:
                taps.append(x)
        center_feats = torch.cat(taps, dim=-1)  # (B, G, taps * D)
        global_feat = torch.cat([center_feats.max(dim=1).values,
                                 center_feats.mean(dim=1)], dim=-1)
        propagated = self.prop_proj(propagate_features(pts, grouped.center, center_feats))
        cls_emb = self.label_embed(F.one_hot(cls_label.long(), self.num_classes).to(dt))
        batch, num_points = pts.shape[:2]
        per_point = torch.cat([
            propagated,
            global_feat[:, None].expand(batch, num_points, -1),
            cls_emb[:, None].expand(batch, num_points, -1),
            pts.to(dt),
        ], dim=-1)
        h = F.relu(self.head_bn1(self.head_fc1(per_point)))
        if self.training:
            if dropout_mask is None:
                h = self.dropout(h)
            else:
                h = torch.where(dropout_mask, h / (1.0 - self.dropout.p), 0.0)
        h = F.relu(self.head_bn2(self.head_fc2(h)))
        return self.head_out(h)

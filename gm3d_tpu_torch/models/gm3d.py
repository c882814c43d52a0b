"""GM3D student: masked autoencoder with dual decoders + per-group loss predictor.

Port of ``gm3d_tpu/models/gm3d.py``, as far as the frozen featurizer of the
serving path needs it: every sub-module is declared under the reference's
names (so that a whole checkpoint loads with ``strict=True``), ``group`` and
``encode_features`` are implemented, and the full student forward arrives
with the pretrain slice.
"""

from __future__ import annotations

import torch
from torch import nn

from gm3d_tpu_torch.models.blocks import (
    PointConv,
    PosEmbedMLP,
    TorchBatchNorm,
    TransformerDecoder,
    init_weights,
)
from gm3d_tpu_torch.models.pointmae import MaskTransformer
from gm3d_tpu_torch.ops.group import Grouped, group_points


class GM3DStudent(nn.Module):
    """GM3D student MAE. Hyperparameters default to the reference's
    hard-coded class values."""

    def __init__(self, trans_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 decoder_depth: int = 4, decoder_num_heads: int = 6,
                 group_size: int = 32, num_group: int = 64,
                 drop_path_rate: float = 0.1, encoder_dims: int = 384,
                 mode: str = "feature", dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("feature", "usual"):
            raise ValueError(f"mode must be 'feature' or 'usual', got {mode!r}")
        self.trans_dim, self.num_group, self.group_size = trans_dim, num_group, group_size
        self.mode = mode
        self.MAE_encoder = MaskTransformer(trans_dim, depth, num_heads, drop_path_rate,
                                           encoder_dims, dtype=dtype, norm_name="norm_p")
        self.MAE_decoder = TransformerDecoder(trans_dim, decoder_depth, decoder_num_heads,
                                              drop_path_rate, dtype=dtype)
        loss_pred_depth = depth if mode == "feature" else decoder_depth
        self.MAE_decoder_loss_pred = TransformerDecoder(
            trans_dim, loss_pred_depth, decoder_num_heads, drop_path_rate, dtype=dtype)
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

    def forward(self, pts, mask, num_mask: int, **kwargs):
        raise NotImplementedError(
            "GM3DStudent.forward (the masked student pass with both decoders) "
            "is ported with the pretrain slice; this slice has group() and "
            "encode_features()")

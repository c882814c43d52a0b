"""Models of the port: PointTransformer classifier, and the encoders of
Point-MAE and the GM3D student. All are ``nn.Module``s with a configurable
compute dtype; parameters are fp32 and carry the reference's names."""

from gm3d_tpu_torch.models.blocks import (
    Attention,
    Block,
    Mlp,
    PatchEncoder,
    PosEmbedMLP,
    TorchBatchNorm,
    TransformerDecoder,
    TransformerEncoder,
)
from gm3d_tpu_torch.models.gm3d import GM3DStudent
from gm3d_tpu_torch.models.point_transformer import Classifier, ClsHead, PointTransformer
from gm3d_tpu_torch.models.pointmae import MaskTransformer, PointMAE

__all__ = [
    "Mlp",
    "Attention",
    "Block",
    "TransformerEncoder",
    "TransformerDecoder",
    "PatchEncoder",
    "PosEmbedMLP",
    "TorchBatchNorm",
    "MaskTransformer",
    "PointMAE",
    "GM3DStudent",
    "PointTransformer",
    "ClsHead",
    "Classifier",
]

"""Models of the port: PointTransformer classifier, the part-segmentation
model PointMAESeg, the encoders of Point-MAE and the GM3D student, and the
hierarchical Point-M2AE with its classifier and seg model, and the CLIP
vision tower of the ``clip`` distillation. All
are ``nn.Module``s with a configurable compute dtype; parameters are fp32 and
carry the reference's names (the segmentation head, which the reference does
not ship, the JAX package's)."""

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
from gm3d_tpu_torch.models.clip import CLIPVisionTower
from gm3d_tpu_torch.models.gm3d import GM3DStudent
from gm3d_tpu_torch.models.m2ae import M2AEEncoder, PointM2AE, PointM2AEClassifier, PointM2AESeg
from gm3d_tpu_torch.models.point_transformer import Classifier, ClsHead, PointTransformer
from gm3d_tpu_torch.models.pointmae import MaskTransformer, PointMAE
from gm3d_tpu_torch.models.segmentation import PointMAESeg

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
    "PointMAESeg",
    "M2AEEncoder",
    "PointM2AE",
    "PointM2AEClassifier",
    "PointM2AESeg",
    "CLIPVisionTower",
]

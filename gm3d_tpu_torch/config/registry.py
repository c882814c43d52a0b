"""String -> builder registry, plus the model builders that map the config
schemas under ``configs/`` onto the modules of this package.

Port of ``gm3d_tpu/config/registry.py`` for the models ported so far:
``PointTransformer``, ``PointTransformerSeg``, ``Point_MAE``, the GM3D
student, ``Point_M2AE`` and its classifiers ``Point_M2AE_ModelNet40`` /
``Point_M2AE_ScanObjectNN`` and its part-segmentation model
``Point_M2AE_SEG``. The dataset readers
of ``data/datasets.py`` register in ``DATASETS`` under the reference ``NAME``."""

from __future__ import annotations

from typing import Callable, Dict

import torch


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Callable] = {}

    def register_module(self, name: str | None = None):
        def deco(fn):
            self._modules[name or fn.__name__] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        if name not in self._modules:
            raise KeyError(f"{name!r} not registered in {self.name}; have {sorted(self._modules)}")
        return self._modules[name]

    def build(self, cfg, **kwargs):
        return self.get(cfg["NAME"])(cfg, **kwargs)


MODELS = Registry("models")
DATASETS = Registry("datasets")


@MODELS.register_module("Point_MAE")
def build_point_mae(cfg, dtype: torch.dtype = torch.float32):
    """Config schema: the ``model`` section of ``configs/pointmae/config.yaml``."""
    from gm3d_tpu_torch.models import PointMAE

    tc = cfg["transformer_config"]
    return PointMAE(
        trans_dim=tc["trans_dim"],
        depth=tc["depth"],
        num_heads=tc["num_heads"],
        decoder_depth=tc["decoder_depth"],
        decoder_num_heads=tc["decoder_num_heads"],
        group_size=cfg["group_size"],
        num_group=cfg["num_group"],
        drop_path_rate=tc["drop_path_rate"],
        encoder_dims=tc["encoder_dims"],
        dtype=dtype,
    )


@MODELS.register_module("PointTransformer")
def build_point_transformer(cfg, dtype: torch.dtype = torch.float32):
    """Config schema: the ``model`` section of
    ``configs/pointmae/finetune_modelnet.yaml``."""
    from gm3d_tpu_torch.models import PointTransformer

    return PointTransformer(
        trans_dim=cfg["trans_dim"],
        depth=cfg["depth"],
        num_heads=cfg["num_heads"],
        cls_dim=cfg["cls_dim"],
        group_size=cfg["group_size"],
        num_group=cfg["num_group"],
        encoder_dims=cfg["encoder_dims"],
        drop_path_rate=cfg["drop_path_rate"],
        dtype=dtype,
    )


@MODELS.register_module("PointTransformerSeg")
def build_seg_model(cfg, dtype: torch.dtype = torch.float32):
    """ShapeNetPart seg model (16 classes / 50 parts,
    ``main_finetune_segmentation.py:232-233``); config schema: the ``model``
    section of ``configs/pointmae/seg_shapenetpart.yaml``, ``feature_blocks``
    optional."""
    from gm3d_tpu_torch.models import PointMAESeg

    return PointMAESeg(
        trans_dim=cfg.get("trans_dim", 384),
        depth=cfg.get("depth", 12),
        num_heads=cfg.get("num_heads", 6),
        group_size=cfg.get("group_size", 32),
        num_group=cfg.get("num_group", 128),
        encoder_dims=cfg.get("encoder_dims", 384),
        drop_path_rate=cfg.get("drop_path_rate", 0.1),
        num_classes=cfg.get("num_classes", 16),
        num_parts=cfg.get("cls_dim", 50),
        feature_blocks=tuple(cfg.get("feature_blocks", (3, 7, 11))),
        dtype=dtype,
    )


def _m2ae_encoder_kwargs(cfg) -> dict:
    """``M2AEEncoder``'s arguments out of a Point-M2AE ``model`` section."""
    return dict(num_groups=tuple(cfg["num_groups"]), group_sizes=tuple(cfg["group_sizes"]),
                encoder_depths=tuple(cfg["encoder_depths"]),
                encoder_dims=tuple(cfg["encoder_dims"]),
                local_radius=tuple(cfg["local_radius"]), num_heads=cfg["num_heads"],
                drop_path_rate=cfg["drop_path_rate"])


@MODELS.register_module("Point_M2AE")
def build_point_m2ae(cfg, dtype: torch.dtype = torch.float32):
    """Config schema: the ``model`` section of ``configs/m2ae/config_Point_M2AE.yaml``."""
    from gm3d_tpu_torch.models import PointM2AE

    return PointM2AE(
        decoder_depths=tuple(cfg["decoder_depths"]),
        decoder_dims=tuple(cfg["decoder_dims"]),
        decoder_up_blocks=tuple(cfg.get("decoder_up_blocks", (1, 1))),
        mask_ratio=cfg.get("mask_ratio", 0.8),
        svm_scales=cfg.get("svm_scales", "all"),
        dtype=dtype,
        **_m2ae_encoder_kwargs(cfg),
    )


def _build_m2ae_classifier(cfg, cls_dim: int, dtype: torch.dtype):
    from gm3d_tpu_torch.models import PointM2AEClassifier

    return PointM2AEClassifier(cls_dim=cls_dim, dtype=dtype, **_m2ae_encoder_kwargs(cfg))


@MODELS.register_module("Point_M2AE_ModelNet40")
def build_m2ae_modelnet(cfg, dtype: torch.dtype = torch.float32):
    """Config schema: the ``model`` section of ``configs/m2ae/finetune_modelnet_PointM2AE.yaml``."""
    return _build_m2ae_classifier(cfg, cfg.get("cls_dim", 40), dtype)


@MODELS.register_module("Point_M2AE_ScanObjectNN")
def build_m2ae_scanobj(cfg, dtype: torch.dtype = torch.float32):
    """Config schema: the ``model`` section of the ScanObjectNN Point-M2AE configs."""
    return _build_m2ae_classifier(cfg, cfg.get("cls_dim", 15), dtype)


@MODELS.register_module("Point_M2AE_SEG")
def build_m2ae_seg_model(cfg, dtype: torch.dtype = torch.float32):
    """ShapeNetPart seg on the Point-M2AE encoder; config schema: the ``model``
    section of ``configs/m2ae/seg_shapenetpart_PointM2AE.yaml``."""
    from gm3d_tpu_torch.models import PointM2AESeg

    return PointM2AESeg(num_classes=cfg.get("num_classes", 16), num_parts=cfg.get("cls_dim", 50),
                        dtype=dtype, **_m2ae_encoder_kwargs(cfg))


@MODELS.register_module("GM3D_Student")
@MODELS.register_module("mae_vit_base_patch16_dec512d8b")
def build_gm3d_student(cfg, dtype: torch.dtype = torch.float32):
    """The GM3D student; hyperparameters are the reference's hard-coded class
    values unless overridden in cfg."""
    from gm3d_tpu_torch.models import GM3DStudent

    return GM3DStudent(
        trans_dim=cfg.get("trans_dim", 384),
        depth=cfg.get("depth", 12),
        num_heads=cfg.get("num_heads", 6),
        decoder_depth=cfg.get("decoder_depth", 4),
        decoder_num_heads=cfg.get("decoder_num_heads", 6),
        group_size=cfg.get("group_size", 32),
        num_group=cfg.get("num_group", 64),
        drop_path_rate=cfg.get("drop_path_rate", 0.1),
        encoder_dims=cfg.get("encoder_dims", 384),
        mode=cfg.get("mode", "feature"),
        dtype=dtype,
    )


def build_model_from_cfg(cfg, **kwargs):
    """Build the model a config's ``model`` section names."""
    return MODELS.build(cfg, **kwargs)

"""String -> builder registry, plus the model builders that map the config
schemas under ``configs/`` onto the modules of this package.

Port of ``gm3d_tpu/config/registry.py`` for the models ported so far:
``PointTransformer``, ``Point_MAE`` and the GM3D student."""

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

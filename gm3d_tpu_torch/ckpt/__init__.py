"""Checkpoints of the port: weights cross over from the JAX package as torch
state dicts under the reference's parameter names."""

from gm3d_tpu_torch.ckpt.torch_import import (
    GM3D_STUDENT_MAP,
    POINT_MAE_MAP,
    POINT_TRANSFORMER_MAP,
    load_flax_variables,
    load_pretrain_models,
    load_torch_file,
    state_dict_from_flax,
)

__all__ = [
    "POINT_TRANSFORMER_MAP",
    "POINT_MAE_MAP",
    "GM3D_STUDENT_MAP",
    "state_dict_from_flax",
    "load_torch_file",
    "load_flax_variables",
    "load_pretrain_models",
]

"""Weights from the JAX package's variable trees to torch state dicts.

Own copy of the name maps and layout rules of
``gm3d_tpu/ckpt/torch_import.py``. :func:`state_dict_from_flax` is the
function that carries weights across: it takes the JAX package's
``variables`` ({'params': ..., 'batch_stats': ...}) as a nested dict of numpy
arrays and returns a torch ``state_dict`` under the reference's names, which
the modules of this package load with ``strict=True``.

Weight-layout rules:
  flax Dense kernel (in, out)  -> torch Linear weight (out, in)      [transpose]
  flax Dense kernel (in, out)  -> torch Conv1d weight (out, in, 1)   [T + axis]
  flax scale/bias              -> torch LN/BN weight/bias
  flax batch_stats mean/var    -> torch BN running_mean/running_var
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# torch module path -> (flax path, kind). {i} expands per block index.
_COMMON_ENCODER = {
    # mini-PointNet patch embed
    "encoder.first_conv.0": ("encoder/conv1", "conv"),
    "encoder.first_conv.1": ("encoder/bn1", "bn"),
    "encoder.first_conv.3": ("encoder/conv2", "conv"),
    "encoder.second_conv.0": ("encoder/conv3", "conv"),
    "encoder.second_conv.1": ("encoder/bn2", "bn"),
    "encoder.second_conv.3": ("encoder/conv4", "conv"),
    # pos embed MLP
    "pos_embed.0": ("pos_embed/fc1", "linear"),
    "pos_embed.2": ("pos_embed/fc2", "linear"),
    # transformer blocks
    "blocks.blocks.{i}.norm1": ("blocks/block{i}/norm1", "ln"),
    "blocks.blocks.{i}.norm2": ("blocks/block{i}/norm2", "ln"),
    "blocks.blocks.{i}.attn.qkv": ("blocks/block{i}/attn/qkv", "linear"),
    "blocks.blocks.{i}.attn.proj": ("blocks/block{i}/attn/proj", "linear"),
    "blocks.blocks.{i}.mlp.fc1": ("blocks/block{i}/mlp/fc1", "linear"),
    "blocks.blocks.{i}.mlp.fc2": ("blocks/block{i}/mlp/fc2", "linear"),
}


def _decoder(name: str) -> Dict[str, Tuple[str, str]]:
    table = {
        f"{name}.blocks.{{i}}.{leaf}": (f"{name}/block{{i}}/{leaf.replace('.', '/')}", kind)
        for leaf, kind in (("norm1", "ln"), ("norm2", "ln"), ("attn.qkv", "linear"),
                           ("attn.proj", "linear"), ("mlp.fc1", "linear"),
                           ("mlp.fc2", "linear"))
    }
    table[f"{name}.norm"] = (f"{name}/norm", "ln")
    return table


def _under(prefix: str, table: Mapping[str, Tuple[str, str]]) -> Dict[str, Tuple[str, str]]:
    return {f"{prefix}.{k}": (f"{prefix}/{v}", kind) for k, (v, kind) in table.items()}


# The encoder's final LayerNorm is ``norm_p`` in PointTransformer and in the
# GM3D student's encoder, ``norm`` in the Point-MAE teacher's.
POINT_TRANSFORMER_MAP = {
    **_COMMON_ENCODER,
    "norm_p": ("norm", "ln"),
    "cls_head_finetune.0": ("cls_head_finetune/fc1", "linear"),
    "cls_head_finetune.1": ("cls_head_finetune/bn1", "bn"),
    "cls_head_finetune.4": ("cls_head_finetune/fc2", "linear"),
    "cls_head_finetune.5": ("cls_head_finetune/bn2", "bn"),
    "cls_head_finetune.8": ("cls_head_finetune/fc3", "linear"),
}

POINT_MAE_MAP = {
    **_under("MAE_encoder", {**_COMMON_ENCODER, "norm": ("norm", "ln")}),
    "decoder_pos_embed.0": ("decoder_pos_embed/fc1", "linear"),
    "decoder_pos_embed.2": ("decoder_pos_embed/fc2", "linear"),
    **_decoder("MAE_decoder"),
    "increase_dim.0": ("increase_dim", "conv"),
}

GM3D_STUDENT_MAP = {
    **_under("MAE_encoder", {**_COMMON_ENCODER, "norm_p": ("norm", "ln")}),
    "decoder_pos_embed.0": ("decoder_pos_embed/fc1", "linear"),
    "decoder_pos_embed.2": ("decoder_pos_embed/fc2", "linear"),
    # feature head
    "increase_dim_2.0": ("head_fc1", "conv"),
    "increase_dim_2.1": ("head_bn", "bn"),
    "increase_dim_2.3": ("head_fc2", "conv"),
    # coordinate head
    "increase_dim_just_network_without_feature.0": ("coord_head", "conv"),
    **_decoder("MAE_decoder"),
    **_decoder("MAE_decoder_loss_pred"),
}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _lookup(flax_path: str, table: Mapping[str, Tuple[str, str]]) -> Optional[Tuple[str, str]]:
    """(torch module path, kind) of a flax module path, or None."""
    for torch_path, (fp, kind) in table.items():
        if "{i}" not in fp:
            if fp == flax_path:
                return torch_path, kind
            continue
        m = re.match("^" + re.escape(fp).replace(r"\{i\}", r"(\d+)") + "$", flax_path)
        if m:
            return torch_path.replace("{i}", m.group(1)), kind
    return None


def state_dict_from_flax(variables: Mapping[str, Any],
                         table: Mapping[str, Tuple[str, str]]) -> Dict[str, torch.Tensor]:
    """flax ``variables`` (nested dict of numpy arrays) -> torch state dict.

    Top-level parameters (``cls_token``, ``cls_pos``, ``mask_token``,
    ``mask_token_loss_pred``) pass through under their own names. A module
    the table does not name is an error: nothing is dropped silently."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, value: np.ndarray) -> None:
        sd[key] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32).copy())

    for path, value in _flatten(variables.get("params", {})).items():
        if "/" not in path:
            put(path, value)
            continue
        module, leaf = path.rsplit("/", 1)
        hit = _lookup(module, table)
        if hit is None:
            raise KeyError(f"no torch name for flax module {module!r}")
        torch_path, kind = hit
        if leaf == "kernel":
            w = value.T
            put(f"{torch_path}.weight", w[..., None] if kind == "conv" else w)
        elif leaf == "scale":
            put(f"{torch_path}.weight", value)
        elif leaf == "bias":
            put(f"{torch_path}.bias", value)
        else:
            raise KeyError(f"unknown parameter leaf {leaf!r} at {path!r}")
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        module, leaf = path.rsplit("/", 1)
        hit = _lookup(module, table)
        if hit is None:
            raise KeyError(f"no torch name for flax module {module!r}")
        put(f"{hit[0]}.{'running_mean' if leaf == 'mean' else 'running_var'}", value)
    return sd


def load_flax_variables(module: torch.nn.Module, variables: Mapping[str, Any],
                        table: Mapping[str, Tuple[str, str]]) -> torch.nn.Module:
    """Load flax ``variables`` (numpy) into ``module`` with ``strict=True``;
    ``num_batches_tracked``, which flax does not have, keeps its value."""
    sd = state_dict_from_flax(variables, table)
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd.setdefault(key, value)
    module.load_state_dict(sd, strict=True)
    return module


def load_pretrain_models(student: torch.nn.Module, ema: Optional[torch.nn.Module],
                         teacher: Optional[torch.nn.Module],
                         student_variables: Mapping[str, Any],
                         ema_variables: Optional[Mapping[str, Any]] = None,
                         teacher_variables: Optional[Mapping[str, Any]] = None) -> None:
    """Carry a JAX GM3D pretrain state across: the ``TrainState``'s student
    variables (``state.variables()``), its EMA variables
    (``state.ema_variables()``) and the Point-MAE teacher's variables, each a
    nested dict of numpy arrays, into the port's student, EMA copy and
    teacher. Every load is strict: a missing or unexpected tensor raises."""
    load_flax_variables(student, student_variables, GM3D_STUDENT_MAP)
    if ema is not None:
        load_flax_variables(ema, ema_variables if ema_variables is not None
                            else student_variables, GM3D_STUDENT_MAP)
    if teacher is not None:
        if teacher_variables is None:
            raise ValueError("a teacher module was given without teacher variables")
        load_flax_variables(teacher, teacher_variables, POINT_MAE_MAP)


def strip_prefixes(key: str) -> str:
    """Strip the ``module.`` (DDP) and ``base_model.`` prefixes of a key."""
    for prefix in ("module.", "base_model."):
        if key.startswith(prefix):
            key = key[len(prefix):]
    return key


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.pth`` and pull out the model weights, trying the known
    layouts in order (``base_model``, ``state_dict``, ``model``, raw); DDP and
    ``base_model.`` key prefixes are stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("base_model", "state_dict", "model", "ema_state_dict"):
        if isinstance(ckpt, dict) and key in ckpt and isinstance(ckpt[key], dict):
            ckpt = ckpt[key]
            break
    return {strip_prefixes(k): torch.as_tensor(v) for k, v in ckpt.items()}

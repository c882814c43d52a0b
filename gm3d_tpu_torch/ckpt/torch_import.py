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
  flax raw parameter           -> torch parameter of the same shape ("param")
  flax Conv kernel (P, P, 3, W) -> torch Conv2d weight (W, 3, P, P)  ("conv2d")
  flax fused qkv Dense         -> MultiheadAttention in_proj_weight / in_proj_bias

:func:`import_clip_visual` reads a CLIP checkpoint (``--clip_path``) into the
port's ``CLIPVisionTower``.
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


def _stack(torch_name: str, flax_name: str) -> Dict[str, Tuple[str, str]]:
    """A stack of blocks: ``{torch}.blocks.{i}`` is ``{flax}/block{i}``."""
    return {f"{torch_name}.blocks.{{i}}.{leaf}":
            (f"{flax_name}/block{{i}}/{leaf.replace('.', '/')}", kind)
            for leaf, kind in (("norm1", "ln"), ("norm2", "ln"), ("attn.qkv", "linear"),
                               ("attn.proj", "linear"), ("mlp.fc1", "linear"),
                               ("mlp.fc2", "linear"))}


def _decoder(name: str) -> Dict[str, Tuple[str, str]]:
    return {**_stack(name, name), f"{name}.norm": (f"{name}/norm", "ln")}


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

# The part-segmentation model: the encoder under PointTransformer's torch names
# (so that pretrain checkpoints overlay onto it as they are), the blocks at the
# root of the flax tree (``block{i}``), no final LayerNorm, the head under its
# flax names.
POINT_MAE_SEG_MAP = {
    **{k: (v.replace("blocks/block{i}", "block{i}"), kind)
       for k, (v, kind) in _COMMON_ENCODER.items()},
    "label_embed": ("label_embed", "linear"),
    "prop_proj": ("prop_proj", "linear"),
    "head_fc1": ("head_fc1", "linear"),
    "head_bn1": ("head_bn1", "bn"),
    "head_fc2": ("head_fc2", "linear"),
    "head_bn2": ("head_bn2", "bn"),
    "head_out": ("head_out", "linear"),
}

# the pretrain-time supervised probe (``--classification``)
CLASSIFIER_MAP = {
    "norm": ("norm", "ln"),
    "head.0": ("head/fc1", "linear"),
    "head.1": ("head/bn1", "bn"),
    "head.4": ("head/fc2", "linear"),
    "head.5": ("head/bn2", "bn"),
    "head.8": ("head/fc3", "linear"),
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


# Point-M2AE. The reference ships no torch code for this family, so there are
# no reference names to follow: the torch keys are the port's own module names
# (``models/m2ae.py``), which keep the flax ones where torch allows
# (``stage{s}``, ``merge{s}``, ``dec_up{i}`` ...); the patch embed, the
# positional embeddings, the blocks and the classifier's head are the port's
# shared modules and keep their torch spellings.
_PATCH_EMBED = {k[len("encoder."):]: (v[len("encoder/"):], kind)
                for k, (v, kind) in _COMMON_ENCODER.items() if k.startswith("encoder.")}


def _pos(torch_name: str, flax_name: str) -> Dict[str, Tuple[str, str]]:
    return {f"{torch_name}.0": (f"{flax_name}/fc1", "linear"),
            f"{torch_name}.2": (f"{flax_name}/fc2", "linear")}


M2AE_SCALES, M2AE_DECODER_STAGES = 3, 2  # every Point-M2AE config's


def _m2ae_encoder() -> Dict[str, Tuple[str, str]]:
    """The ``M2AEEncoder`` under ``encoder``."""
    table = _under("encoder", {f"patch_embed.{k}": (f"patch_embed/{v}", kind)
                               for k, (v, kind) in _PATCH_EMBED.items()})
    for s in range(M2AE_SCALES):
        table.update(_stack(f"encoder.stage{s}", f"encoder/stage{s}"))
        table.update(_pos(f"encoder.pos{s}", f"encoder/pos{s}"))
        table[f"encoder.mask_feat{s}"] = (f"encoder/mask_feat{s}", "param")
        if s:
            table[f"encoder.merge{s}.proj"] = (f"encoder/merge{s}/proj", "linear")
    return table


def _m2ae_pretrain() -> Dict[str, Tuple[str, str]]:
    """``PointM2AE``: the encoder, the decoder (a stage, a positional embedding
    and a projection a stage; an up-block stack a stage), the heads."""
    table = _m2ae_encoder()
    for i in range(M2AE_DECODER_STAGES):
        table.update(_stack(f"dec_stage{i}", f"dec_stage{i}"))
        table.update(_stack(f"dec_up{i}", f"dec_up{i}"))
        table.update(_pos(f"dec_pos{i}", f"dec_pos{i}"))
        table[f"dec_proj{i}"] = (f"dec_proj{i}", "linear")
    table.update({"rec_head": ("rec_head", "linear"), "lp_fc1": ("lp_fc1", "linear"),
                  "lp_bn": ("lp_bn", "bn"), "lp_fc2": ("lp_fc2", "linear")})
    return table


_M2AE_NORMS = {f"norm{s}": (f"norm{s}", "ln") for s in range(M2AE_SCALES)}
M2AE_MAP = _m2ae_pretrain()
# the classifier: the encoder, a LayerNorm a scale, the head
M2AE_CLASSIFIER_MAP = {**_m2ae_encoder(), **_M2AE_NORMS,
                       "cls_head_finetune.0": ("head_fc1", "linear"),
                       "cls_head_finetune.1": ("head_bn1", "bn"),
                       "cls_head_finetune.4": ("head_fc2", "linear"),
                       "cls_head_finetune.5": ("head_bn2", "bn"),
                       "cls_head_finetune.8": ("head_out", "linear")}
# the seg model: the encoder, a LayerNorm a scale, PointMAESeg's head
M2AE_SEG_MAP = {**_m2ae_encoder(), **_M2AE_NORMS,
                **{k: v for k, v in POINT_MAE_SEG_MAP.items()
                   if k.startswith(("label_embed", "prop_proj", "head_"))}}


# The CLIP vision tower (``models/clip.py``) under the reference's CLIP names.
# Two layouts of their own: the NHWC conv kernel (P, P, 3, W) is the torch
# Conv2d weight (W, 3, P, P), and the fused qkv Dense is the in-projection of
# ``nn.MultiheadAttention`` (``in_proj_weight`` (3W, W), ``in_proj_bias``).
CLIP_VISUAL_MAP = {
    "conv1": ("conv1", "conv2d"),
    "ln_pre": ("ln_pre", "ln"),
    "ln_post": ("ln_post", "ln"),
    "transformer.resblocks.{i}.ln_1": ("block{i}/ln_1", "ln"),
    "transformer.resblocks.{i}.ln_2": ("block{i}/ln_2", "ln"),
    "transformer.resblocks.{i}.attn": ("block{i}/attn/qkv", "in_proj"),
    "transformer.resblocks.{i}.attn.out_proj": ("block{i}/attn/out", "linear"),
    "transformer.resblocks.{i}.mlp.c_fc": ("block{i}/c_fc", "linear"),
    "transformer.resblocks.{i}.mlp.c_proj": ("block{i}/c_proj", "linear"),
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
    ``mask_token_loss_pred``; the CLIP tower's ``class_embedding``,
    ``positional_embedding``, ``proj``) pass through under their own names. A
    module the table does not name is an error: nothing is dropped silently."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, value: np.ndarray) -> None:
        sd[key] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32).copy())

    for path, value in _flatten(variables.get("params", {})).items():
        if "/" not in path:
            put(path, value)
            continue
        hit = _lookup(path, table)
        if hit is not None and hit[1] == "param":
            put(hit[0], value)
            continue
        module, leaf = path.rsplit("/", 1)
        hit = _lookup(module, table)
        if hit is None:
            raise KeyError(f"no torch name for flax module {module!r}")
        torch_path, kind = hit
        prefix = f"{torch_path}.in_proj_" if kind == "in_proj" else f"{torch_path}."
        if leaf == "kernel":
            if kind == "conv2d":
                put(f"{prefix}weight", value.transpose(3, 2, 0, 1))
            else:
                w = value.T
                put(f"{prefix}weight", w[..., None] if kind == "conv" else w)
        elif leaf == "scale":
            put(f"{prefix}weight", value)
        elif leaf == "bias":
            put(f"{prefix}bias", value)
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


def import_clip_visual(state_dict: Mapping[str, Any]) -> Tuple[Dict[str, int],
                                                               Dict[str, torch.Tensor]]:
    """A CLIP checkpoint -> (tower config, the tower's state dict).

    Takes a full CLIP state dict (its ``visual.*`` part, the ``--clip_path``
    file) or a bare vision tower's, and infers the config as the reference's
    ``build_model`` does: the patch from ``conv1``, the grid from the
    positional embedding, ``heads = width // 64``, ``output_dim`` from
    ``proj``. The state dict loads into ``CLIPVisionTower(**config)`` with
    ``strict=True``."""
    keys = {strip_prefixes(k): v for k, v in state_dict.items()}
    if any(k.startswith("visual.") for k in keys):
        keys = {k[len("visual."):]: v for k, v in keys.items() if k.startswith("visual.")}
    sd = {k: torch.as_tensor(v).to(torch.float32) for k, v in keys.items()}
    width, _, patch, _ = sd["conv1.weight"].shape
    grid2 = sd["positional_embedding"].shape[0] - 1
    layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    cfg = dict(input_resolution=int(round(grid2 ** 0.5)) * patch, patch_size=int(patch),
               width=int(width), layers=layers, heads=int(width) // 64,
               output_dim=int(sd["proj"].shape[1]))
    return cfg, sd

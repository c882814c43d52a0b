"""Dynamic-int8 post-training quantization (w8a8) for serving artifacts and
the GM3D step's EMA pass.

Port of ``gm3d_tpu/serve/quantize.py``. The scheme is the JAX package's:

- **Weights**: symmetric int8 per output channel (``quantize_kernel``: the
  absmax over each row of a torch ``(out, in)`` weight, which is the JAX
  kernel's input axis).
- **Activations**: symmetric int8 per token (row), scales from each row's
  absmax, computed on the fly.
- The int8 x int8 product accumulates in int32; the result is rescaled and
  the bias added in fp32, then cast to the layer's compute dtype.
- **Everything else** (LayerNorm, BatchNorm, softmax, GELU, the attention
  score and value products) stays in the compute dtype.

Where it applies: every ``models/blocks.py::Dense`` and ``::PointConv``
product inside :func:`quantized_dense` (through ``blocks.dense_interceptor``,
as the JAX package intercepts every ``nn.Dense.__call__``). The fused
attention and patch-embed routes read their weights themselves and stay
fp32, as the JAX package's fused routes escape its interceptor.

The int8 product is no port of a TPU kernel (the JAX package computes it with
``jax.lax.dot_general`` outside any Pallas kernel): it is the custom op
``gm3d::int8_mm`` of ``ops/int8.py``, on the card ``torch._int_mm``, whose
shapes must have more than 16 rows and inner and output sizes that are
multiples of 8, so the operands are padded with zeros (exact); on the CPU an
int32 matmul. On a CUDA tensor the product never becomes a float product.

An artifact exported with ``--quantize int8`` is traced from a copy of the
model converted by ``quantize_module`` inside ``quantized_dense()``
(``serve/export.py::export_forward``): its program holds the int8 weights
and their scales, and runs the op on the device it is loaded on.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from gm3d_tpu_torch.models.blocks import Dense, PointConv, dense_interceptor
from gm3d_tpu_torch.ops.int8 import int8_matmul, padded_int_mm  # noqa: F401

QUANT_LAYERS = (Dense, PointConv)


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an ``(out, in)`` weight:
    ``(q int8 (out, in), scale fp32 (out,))``."""
    w = weight.detach().to(torch.float32)
    scale = w.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (token) symmetric int8 of ``x (M, K)``: ``(q int8, scale fp32 (M, 1))``."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def int8_linear(x: torch.Tensor, q_weight: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """w8a8 dense layer (the JAX ``_int8_dense``): ``x (..., K)``, an int8
    ``(N, K)`` weight with its per-channel scales -> ``(..., N)`` in
    ``out_dtype``."""
    lead = x.shape[:-1]
    q_x, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    y = int8_matmul(q_x, q_weight).to(torch.float32) * x_scale * w_scale
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype).reshape(*lead, q_weight.shape[0])


def _int8_layer(module: nn.Module, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The interceptor: a quantized module's int8 weight and scales, or a float
    weight quantized here (the EMA pass, whose weights move every step)."""
    if weight.dtype == torch.int8:
        q_weight, w_scale = weight, module.weight_scale
    else:
        q_weight, w_scale = quantize_kernel(weight)
    return int8_linear(x, q_weight, w_scale, module.bias, module.compute_dtype)


@contextlib.contextmanager
def quantized_dense() -> Iterator[None]:
    """Every ``Dense`` / ``PointConv`` product inside this scope is a
    dynamic-int8 w8a8 product (a context variable: other threads keep
    theirs)."""
    with dense_interceptor(_int8_layer):
        yield


def _layers(model: nn.Module):
    """The quantized layers, picked by module type (a ``PointConv`` weight is
    3-D, and so are tokens and positions that stay float)."""
    return [(name, m) for name, m in model.named_modules() if isinstance(m, QUANT_LAYERS)]


def quantize_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` converted by :func:`quantize_module` (the
    JAX ``quantize_variables``); ``model`` is left as it is."""
    return quantize_module(copy.deepcopy(model)).state_dict()


def quantize_module(model: nn.Module) -> nn.Module:
    """Convert ``model`` in place: each quantized layer's float weight becomes
    an int8 buffer ``weight`` and an fp32 buffer ``weight_scale``, so its
    state dict is :func:`quantize_state_dict`'s and such a state dict loads
    into it with ``strict=True``. The model then runs inside
    :func:`quantized_dense` only. Returns ``model``."""
    for _, m in _layers(model):
        if m.weight.dtype == torch.int8:
            continue
        shape = m.weight.shape
        q, scale = quantize_kernel(m.weight.reshape(shape[0], -1))
        del m.weight
        m.register_buffer("weight", q.reshape(shape))
        m.register_buffer("weight_scale", scale)
    return model

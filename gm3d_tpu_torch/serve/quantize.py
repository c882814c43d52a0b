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
``jax.lax.dot_general`` outside any Pallas kernel): on the card it is
``torch._int_mm``, whose shapes must have more than 16 rows and inner and
output sizes that are multiples of 8, so the operands are padded with zeros
(exact); on the CPU an int32 matmul. On a CUDA tensor the product never
becomes a float product.

An artifact exported with ``--quantize int8`` holds the int8 weights and
their scales (``quantize_module``); ``serve/export.py::load_artifact``
converts the rebuilt model the same way before its strict load.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gm3d_tpu_torch.models.blocks import Dense, PointConv, dense_interceptor

QUANT_LAYERS = (Dense, PointConv)
# torch._int_mm on CUDA: more than 16 rows; inner and output sizes multiples of 8
_MIN_ROWS, _ALIGN = 17, 8


def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an ``(out, in)`` weight:
    ``(q int8 (out, in), scale fp32 (out,))``."""
    w = weight.detach().to(torch.float32)
    scale = w.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def padded_int_mm(qx: torch.Tensor, qw: torch.Tensor, mm=None) -> torch.Tensor:
    """``mm(qx', qw'.T)[:M, :N]`` (``mm``: ``torch._int_mm``) on ``qx (M, K)``
    and ``qw (N, K)`` zero-padded to more than 16 rows and to multiples of 8 in
    K and N, which ``torch._int_mm`` requires on the card. Zero rows and
    columns add nothing to an integer product: the result is exact."""
    mm = torch._int_mm if mm is None else mm
    m, k = qx.shape
    n = qw.shape[0]
    mp, kp, np_ = max(_ceil(m, _ALIGN), _MIN_ROWS), _ceil(k, _ALIGN), _ceil(n, _ALIGN)
    if (mp, kp) != (m, k):
        qx = F.pad(qx, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        qw = F.pad(qw, (0, kp - k, 0, np_ - n))
    return mm(qx.contiguous(), qw.contiguous().t())[:m, :n]


def int8_matmul(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """``qx (M, K) int8 @ qw (N, K).T int8 -> (M, N) int32``, exact: on the
    card ``torch._int_mm`` (:func:`padded_int_mm`), on the CPU an int32
    matmul."""
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {qx.dtype} and {qw.dtype}")
    if qx.is_cuda:
        return padded_int_mm(qx, qw)
    return torch.matmul(qx.to(torch.int32), qw.to(torch.int32).t())


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

"""Transformer building blocks and the mini-PointNet patch embed.

Port of ``gm3d_tpu/models/blocks.py`` as ``nn.Module``s whose parameter
names are the reference's (``blocks.blocks.{i}.attn.qkv.weight``,
``encoder.first_conv.0.weight`` ...), so that a state dict in those names
loads with ``strict=True``.

Compute dtype: every module takes ``dtype`` (``torch.float32`` or
``torch.bfloat16``). Parameters stay fp32 and are cast where they are used,
at the same places as the flax modules cast them: a dense layer rounds input,
weight and bias to ``dtype``; LayerNorm and BatchNorm compute in fp32 and
cast the result; the attention softmax runs in fp32. There is no
``torch.autocast``, whose rounding points differ.

Behaviours preserved:
  - positional embedding is added at the input of EVERY block, not once at
    the stem;
  - pre-norm blocks with stochastic depth ramped linearly over depth;
  - the patch embed is a two-stage mini-PointNet with a global max-pool
    concat.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gm3d_tpu_torch.ops.fused_attention import fused_attention_trainable, kernel_fits
from gm3d_tpu_torch.parallel.context import active, draw_rows
from gm3d_tpu_torch.parallel.mesh import all_reduce_sum

# reference init: trunc_normal(std=0.02) for Linear/Conv weights, zero bias
INIT_STD = 0.02

# Call-time switch (the train step's fast path): inside
# ``fused_attention_scope`` mask-free attention whose sequence the kernels
# hold (``ops.fused_attention.kernel_fits``: at most 64 tokens) goes through
# ``ops.fused_attention`` (the CUDA kernels for a CUDA tensor, the plain
# version for a CPU tensor). A masked or longer site stays plain, as the JAX
# package's ``_fused_block_batch`` declines it. Outside the scope, as on the
# serving path, ``Attention`` is plain tensor code.
# A context variable: a train step in one thread does not switch the route
# of a server answering in another.
_FUSED_ATTENTION: contextvars.ContextVar = contextvars.ContextVar(
    "gm3d_fused_attention", default=False)


@contextlib.contextmanager
def fused_attention_scope(enabled: bool = True):
    """Route mask-free attention through the fused attention op (with its
    backward kernel) inside this scope."""
    token = _FUSED_ATTENTION.set(bool(enabled))
    try:
        yield
    finally:
        _FUSED_ATTENTION.reset(token)


# Call-time interceptor of every ``Dense`` and ``PointConv`` product: inside
# ``dense_interceptor(fn)`` each of them returns ``fn(module, x, weight)``
# (``weight`` the 2-D ``(out, in)`` view) instead of its float product. The
# dynamic-int8 route of ``serve/quantize.py::quantized_dense`` is the one
# user, as ``nn.intercept_methods`` is the JAX package's. The fused attention
# and patch-embed routes read the weights themselves and stay float, as the
# JAX package's fused routes escape its interceptor. A context variable, like
# ``_FUSED_ATTENTION``.
_DENSE_INTERCEPTOR: contextvars.ContextVar = contextvars.ContextVar(
    "gm3d_dense_interceptor", default=None)


@contextlib.contextmanager
def dense_interceptor(fn):
    """Route every ``Dense`` / ``PointConv`` product through ``fn(module, x,
    weight)`` inside this scope."""
    token = _DENSE_INTERCEPTOR.set(fn)
    try:
        yield
    finally:
        _DENSE_INTERCEPTOR.reset(token)


def _linear(module: nn.Module, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The product of ``Dense`` and ``PointConv``: the interceptor's where one
    is set, else input, weight and bias rounded to the compute dtype. An int8
    weight (``serve/quantize.py::quantize_module``) has no float product."""
    intercept = _DENSE_INTERCEPTOR.get()
    if intercept is not None:
        return intercept(module, x, weight)
    if weight.dtype == torch.int8:
        raise RuntimeError("an int8-quantized layer runs inside "
                           "gm3d_tpu_torch.serve.quantize.quantized_dense()")
    dt = module.compute_dtype
    bias = None if module.bias is None else module.bias.to(dt)
    return F.linear(x.to(dt), weight.to(dt), bias)


def trunc_normal_(tensor: torch.Tensor, generator: Optional[torch.Generator] = None,
                  std: float = INIT_STD) -> torch.Tensor:
    return nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class Dense(nn.Linear):
    """``nn.Linear`` that rounds input, weight and bias to ``dtype`` before
    the product (what ``flax.linen.Dense(dtype=...)`` does)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self, x, self.weight)


class PointConv(nn.Module):
    """Per-point ``Conv1d(kernel_size=1)`` applied over the LAST axis.

    The weight keeps the reference's Conv1d shape ``(out, in, 1)`` so that
    state dicts match; the product is a plain matmul over the channel axis
    (channels-last, like the JAX package's Dense), which also keeps fp32
    inputs in full fp32 on the GPU (cuDNN convolutions default to TF32)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.compute_dtype = dtype
        trunc_normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self, x, self.weight[..., 0])


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) computed in fp32, result cast to ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class TorchBatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over the LAST axis of a channels-last tensor.

    Same state (``weight``, ``bias``, ``running_mean``, ``running_var``) and
    running-stat rules as ``nn.BatchNorm1d`` (biased variance to normalise,
    Bessel-corrected variance stored; momentum 0.1 here is the JAX module's
    0.9). Statistics and the normalisation run in fp32 whatever the compute
    dtype; the result is cast to ``dtype``.

    Under data parallelism (``parallel/context.py``) the train-mode
    statistics are the GLOBAL batch's, as the JAX step's are by construction
    (``_global_batch_norm``); ``nn.SyncBatchNorm`` is not used, since it
    refuses CPU tensors and gathers with ``all_gather``, which gloo lacks for
    CUDA tensors."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            flat = xf.reshape(-1, xf.shape[-1])
            ctx = active()
            if ctx is not None:
                y = self._global_batch_norm(flat, ctx).reshape(xf.shape)
            else:
                y = F.batch_norm(flat, self.running_mean, self.running_var, self.weight,
                                 self.bias, True, self.momentum, self.eps).reshape(xf.shape)
        else:
            y = (xf - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            y = y * self.weight + self.bias
        return y.to(self.compute_dtype)

    def _global_batch_norm(self, flat: torch.Tensor, ctx) -> torch.Tensor:
        """Train-mode batch norm over every rank's rows: the mean from the
        all-reduced sum and count, then the biased variance from the
        all-reduced sum of squared deviations (two passes, as the
        single-process kernel computes it). Both reductions are
        differentiable all-reduces, so the backward sums every rank's share
        of the statistics' gradient. The running variance's Bessel factor
        uses the global count."""
        ch = flat.shape[-1]
        count = torch.full((1,), float(flat.shape[0]), device=flat.device)
        sums = all_reduce_sum(torch.cat([flat.sum(0), count]), ctx.group)
        n = sums[ch]
        mean = sums[:ch] / n
        centered = flat - mean
        var = all_reduce_sum((centered * centered).sum(0), ctx.group) / n
        y = centered * torch.rsqrt(var + self.eps) * self.weight + self.bias
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach() * (n / (n - 1.0)), alpha=m)
            self.num_batches_tracked.add_(1)
        return y


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              generator: Optional[torch.Generator] = None,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic depth: drop the residual branch per sample. ``keep`` (B, 1,
    ..., 1) bool, a mask drawn beforehand (``draw_depth_masks``), replaces the
    draw from ``generator``; in train mode a nonzero rate needs one of them."""
    if deterministic or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if keep is None:
        if generator is None:
            raise ValueError("stochastic depth in train mode needs drawn keep masks "
                             "or a generator")
        keep = _draw_keep(generator, keep_prob, (x.shape[0],) + (1,) * (x.ndim - 1),
                          x.device)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _draw_keep(generator: Optional[torch.Generator], keep_prob: float, shape,
               device) -> torch.Tensor:
    return draw_rows(lambda s: torch.rand(s, device=device, generator=generator),
                     shape) < keep_prob


def draw_depth_masks(generator: Optional[torch.Generator], encoders: Sequence[nn.Module],
                     batch: int, device=None) -> tuple:
    """The keep masks of stochastic depth for one train-mode forward through
    ``encoders`` (``TransformerEncoder``s in the order the forward runs them):
    for each encoder, for each block, the attention branch's and the MLP
    branch's (batch, 1, 1) bool, drawn from ``generator`` in the order and
    shape ``drop_path`` draws them inside the forward, so that either route
    takes the same numbers from a generator; ``()`` for a block of rate 0,
    which draws nothing. The forward takes them as ``depth_masks``, which is how a
    forward under ``torch.func.vmap`` (no random draw inside) gets them."""
    return tuple(
        tuple(() if block.drop_path_rate == 0.0 else
              tuple(_draw_keep(generator, 1.0 - block.drop_path_rate, (batch, 1, 1), device)
                    for _ in range(2))
              for block in encoder.blocks)
        for encoder in encoders)


class Mlp(nn.Module):
    """Transformer MLP, 4x expansion, erf GELU."""

    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype = torch.float32,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype)
        self.drop = nn.Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(F.gelu(self.fc1(x)))
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """Multi-head self-attention; qkv has no bias by default.

    Plain tensor code (matmul, softmax), as the JAX serving path leaves it to
    its compiler; inside ``fused_attention_scope`` the whole sublayer is one
    call of ``ops.fused_attention`` when there is no mask, dropout is inert
    and the kernels hold the sequence (``kernel_fits``). ``attn_mask``:
    (B, N, N) bool, True where attention is allowed; masked scores become
    -1e9."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 qkv_bias: bool = False, attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not divisible by {num_heads} heads")
        self.dim, self.num_heads, self.compute_dtype = dim, num_heads, dtype
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        batch, seq, _ = x.shape
        # the fused op applies no dropout: take it only when dropout is inert
        dropout_inert = not self.training or (
            self.attn_drop.p == 0.0 and self.proj_drop.p == 0.0)
        if (_FUSED_ATTENTION.get() and attn_mask is None and dropout_inert
                and kernel_fits(seq, self.dim, self.num_heads)):
            # weights rounded to the compute dtype first, as Dense rounds
            # them; (out, in) storage goes over as a transposed view
            dt = self.compute_dtype
            bqkv = None if self.qkv.bias is None else self.qkv.bias.to(dt)
            return fused_attention_trainable(
                x.to(dt), self.qkv.weight.to(dt).t(), bqkv,
                self.proj.weight.to(dt).t(), self.proj.bias.to(dt), self.num_heads)
        head_dim = self.dim // self.num_heads
        scale = head_dim ** -0.5
        qkv = self.qkv(x).reshape(batch, seq, 3, self.num_heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, H, N, D)
        attn = torch.matmul(q, k.transpose(-1, -2)) * scale
        attn = attn.to(torch.float32)
        if attn_mask is not None:
            attn = torch.where(attn_mask[:, None, :, :], attn,
                               torch.full((), -1e9, device=attn.device))
        attn = torch.softmax(attn, dim=-1).to(self.compute_dtype)
        attn = self.attn_drop(attn)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(batch, seq, self.dim)
        return self.proj_drop(self.proj(out))


class Block(nn.Module):
    """Pre-norm ViT block with DropPath."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32,
                 qkv_bias: bool = False):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, dtype=dtype, qkv_bias=qkv_bias)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``keep``: the two branches' stochastic-depth keep masks, in place of
        draws from ``generator`` (None or empty: none given)."""
        det = not self.training
        keep_attn, keep_mlp = keep if keep else (None, None)
        h = self.attn(self.norm1(x), attn_mask)
        x = x + drop_path(h, self.drop_path_rate, det, generator, keep_attn)
        h = self.mlp(self.norm2(x))
        return x + drop_path(h, self.drop_path_rate, det, generator, keep_mlp)


def _dpr(drop_path_rate: float, depth: int) -> Sequence[float]:
    """Linear stochastic-depth ramp, matching torch.linspace(0, rate, depth)."""
    if depth == 1:
        return [0.0]
    return [drop_path_rate * i / (depth - 1) for i in range(depth)]


def _blocks(dim, depth, num_heads, drop_path_rate, dtype) -> nn.ModuleList:
    return nn.ModuleList(
        Block(dim, num_heads, drop_path_rate=rate, dtype=dtype)
        for rate in _dpr(drop_path_rate, depth))


class TransformerEncoder(nn.Module):
    """Stack of blocks; pos is added at EVERY block input."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 drop_path_rate: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = _blocks(dim, depth, num_heads, drop_path_rate, dtype)

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                depth_masks: Optional[Sequence] = None) -> torch.Tensor:
        """``depth_masks``: one entry a block of ``draw_depth_masks``' (its
        keep masks, or ``()``), in place of draws from ``generator``."""
        if depth_masks is None:
            depth_masks = (None,) * len(self.blocks)
        for block, keep in zip(self.blocks, depth_masks, strict=True):
            x = block(x + pos, attn_mask, generator, keep)
        return x


class TransformerDecoder(nn.Module):
    """Decoder stack + final LayerNorm; ``return_tokens`` keeps only the last
    tokens (the mask tokens), 0 returns the full normed sequence."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 drop_path_rate: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = _blocks(dim, depth, num_heads, drop_path_rate, dtype)
        self.norm = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, return_tokens: int = 0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x + pos, None, generator)
        x = self.norm(x)
        if return_tokens:
            x = x[:, -return_tokens:]
        return x


class PatchEncoder(nn.Module):
    """Mini-PointNet patch embed.

    Per group: conv(3->128) BN ReLU conv(128->256); global max; concat;
    conv(512->512) BN ReLU conv(512->out); max over points. BatchNorm
    statistics reduce over batch, group and point axes."""

    def __init__(self, out_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.first_conv = nn.Sequential(
            PointConv(3, 128, dtype), TorchBatchNorm(128, dtype), nn.ReLU(),
            PointConv(128, 256, dtype))
        self.second_conv = nn.Sequential(
            PointConv(512, 512, dtype), TorchBatchNorm(512, dtype), nn.ReLU(),
            PointConv(512, out_dim, dtype))

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        x = self.first_conv(point_groups)  # (B, G, S, 256)
        g = x.max(dim=-2, keepdim=True).values  # (B, G, 1, 256)
        x = torch.cat([g.expand_as(x), x], dim=-1)  # (B, G, S, 512)
        x = self.second_conv(x)
        return x.max(dim=-2).values  # (B, G, out_dim)


class PosEmbedMLP(nn.Sequential):
    """Positional embedding on 3D centers: Linear-GELU-Linear."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(Dense(3, 128, dtype=dtype), nn.GELU(), Dense(128, dim, dtype=dtype))


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Reference init over a whole model: trunc-normal(0.02) weights and zero
    biases for dense and per-point conv layers, ones/zeros for the norms."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, PointConv)):
            trunc_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)

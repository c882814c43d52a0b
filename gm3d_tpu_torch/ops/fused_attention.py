"""Fused multi-head self-attention sublayer, forward and backward.

Port of ``gm3d_tpu/ops/fused_attention.py``:

    y = proj(softmax(q k^T / sqrt(hd)) v),   q, k, v = split(x @ wqkv + bqkv)

Layouts are the JAX package's: ``x`` (B, L, D); ``wqkv`` (D, 3D) with output
columns laid out (3, H, hd); ``wproj`` (D, D), rows (H, hd). ``nn.Linear``
stores (out, in): hand its weight over as the transposed VIEW
(``linear.weight.t()``); the kernels address weights by strides and copy
nothing. ``bqkv`` may be ``None`` (qkv has no bias by default). Sums are
fp32 inside; ``x`` and the weights are fp32 or bf16 (one type for all), ``y``
and ``dx`` come back in ``x``'s type and the weight gradients in the weights'.

Two implementations of each function:

  - ``reference_attention``: plain PyTorch; its autograd is the plain version
    of the backward (``attention_backward_plain``). The CPU tests use them and
    the kernels are held against them on the card.
  - the CUDA kernels of ``csrc/fused_attention.cu`` (one block per cloud),
    which ``fused_attention`` and ``fused_attention_backward`` launch for
    every CUDA tensor. Every product in them runs on the tensor cores at
    fp32 accuracy: operands split into two TF32 halves, three ``mma`` passes
    into fp32 accumulators (``csrc/tile_mma.cuh``; ``ops/tile_mma.py`` is the
    plain version of that arithmetic).

The wrappers take the plain versions only for tensors that lie on the CPU.
For CUDA tensors they launch the kernel or raise. The backward kernel sums
the weight gradients over the clouds with ``atomicAdd``: their last bits
change from run to run.

``fused_attention_trainable`` is the differentiable entry
(``FusedAttentionFunction``): it saves ``x`` and the weights only and the
backward recomputes the rest.
"""

from __future__ import annotations

from typing import Optional

import torch

from gm3d_tpu_torch.ops import _build

# a block of the kernels holds one head of one cloud in (64, 64) buffers
MAX_LEN = 64
MAX_HEAD_DIM = 64


def _check(x, wqkv, bqkv, wproj, bproj, heads: int) -> None:
    if x.ndim != 3:
        raise ValueError(f"expected (B, L, D) x, got {tuple(x.shape)}")
    dim = x.shape[-1]
    if heads < 1 or dim % heads:
        raise ValueError(f"dim {dim} is not divisible by {heads} heads")
    if tuple(wqkv.shape) != (dim, 3 * dim) or tuple(wproj.shape) != (dim, dim):
        raise ValueError(f"expected wqkv ({dim}, {3 * dim}) and wproj ({dim}, {dim}), got "
                         f"{tuple(wqkv.shape)} and {tuple(wproj.shape)}")
    if bqkv is not None and tuple(bqkv.shape) != (3 * dim,):
        raise ValueError(f"expected bqkv ({3 * dim},), got {tuple(bqkv.shape)}")
    if tuple(bproj.shape) != (dim,):
        raise ValueError(f"expected bproj ({dim},), got {tuple(bproj.shape)}")
    for name, t in (("wqkv", wqkv), ("bqkv", bqkv), ("wproj", wproj), ("bproj", bproj)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
        if t.dtype != x.dtype:
            raise ValueError(f"x is {x.dtype} but {name} is {t.dtype}")


def kernel_fits(length: int, dim: int, heads: int) -> bool:
    """Whether the kernels hold a sequence of ``length`` tokens of width
    ``dim`` in ``heads`` heads (one head of one cloud a block)."""
    return length <= MAX_LEN and dim // heads <= MAX_HEAD_DIM


def _check_kernel_limits(x: torch.Tensor, heads: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the attention kernels take fp32 or bf16, got {x.dtype}")
    length, dim = x.shape[1], x.shape[2]
    if not kernel_fits(length, dim, heads):
        raise ValueError(
            f"the attention kernels hold one head of one cloud in shared memory: at most "
            f"{MAX_LEN} tokens and head_dim {MAX_HEAD_DIM}, got {length} and {dim // heads}")


def reference_attention(x, wqkv, bqkv, wproj, bproj, heads: int = 6,
                        matmul=torch.matmul) -> torch.Tensor:
    """Plain version: identical math, identical weight layout. ``matmul``
    computes its four products (the tests put the kernels' 3xTF32 emulation
    there)."""
    _check(x, wqkv, bqkv, wproj, bproj, heads)
    batch, length, dim = x.shape
    hd = dim // heads
    f32 = torch.float32
    qkv = matmul(x.to(f32), wqkv.to(f32))
    if bqkv is not None:
        qkv = qkv + bqkv.to(f32)
    q, k, v = qkv.reshape(batch, length, 3, heads, hd).permute(2, 0, 3, 1, 4)  # (B, H, L, hd)
    attn = torch.softmax(matmul(q, k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
    y = matmul(attn, v).transpose(1, 2).reshape(batch, length, dim)
    return (matmul(y, wproj.to(f32)) + bproj.to(f32)).to(x.dtype)


def attention_backward_plain(x, dy, wqkv, bqkv, wproj, heads: int = 6):
    """Plain version of the backward: autograd of ``reference_attention``.
    Returns (dx, dwqkv, dbqkv or None, dwproj, dbproj)."""
    leaves = [t.detach().requires_grad_(True) for t in (x, wqkv, wproj)]
    bias = None if bqkv is None else bqkv.detach().requires_grad_(True)
    bproj = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device, requires_grad=True)
    with torch.enable_grad():
        y = reference_attention(leaves[0], leaves[1], bias, leaves[2], bproj, heads)
    inputs = leaves + [bproj] + ([] if bias is None else [bias])
    grads = torch.autograd.grad(y, inputs, dy.to(y.dtype))
    dx, dwqkv, dwproj, dbproj = grads[:4]
    return dx, dwqkv, (None if bias is None else grads[4]), dwproj, dbproj


def fused_attention(x, wqkv, bqkv: Optional[torch.Tensor], wproj, bproj,
                    heads: int = 6) -> torch.Tensor:
    """The attention sublayer, forward only. Returns y (B, L, D) in x's type."""
    _check(x, wqkv, bqkv, wproj, bproj, heads)
    if not x.is_cuda:
        return reference_attention(x, wqkv, bqkv, wproj, bproj, heads)
    _check_kernel_limits(x, heads)
    batch, length, dim = x.shape
    x = x.contiguous()
    bproj = bproj.contiguous()
    bqkv = None if bqkv is None else bqkv.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        # the heads' partial sums are fp32; for fp32 they are summed in y itself
        yacc = y if x.dtype == torch.float32 else torch.empty(
            x.shape, dtype=torch.float32, device=x.device)
        lib = _build.load_library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gm3d_attn_fwd(
                x.data_ptr(), wqkv.data_ptr(), wqkv.stride(0), wqkv.stride(1),
                None if bqkv is None else bqkv.data_ptr(),
                wproj.data_ptr(), wproj.stride(0), wproj.stride(1), bproj.data_ptr(),
                yacc.data_ptr(), y.data_ptr(), batch, length, dim, heads,
                int(x.dtype == torch.bfloat16), stream)
        _build.check_launch(rc, "fused_attention")
        _build.count_launch(fused_attention)
    return y


def fused_attention_backward(x, dy, wqkv, bqkv: Optional[torch.Tensor], wproj,
                             heads: int = 6):
    """Backward of ``fused_attention`` from x, dy and the weights.

    Returns (dx, dwqkv, dbqkv or None, dwproj, dbproj): dx in x's type, the
    rest in the weights' type; dwqkv and dwproj have the strides of the
    weights they belong to."""
    bproj = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
    _check(x, wqkv, bqkv, wproj, bproj, heads)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    if not x.is_cuda:
        return attention_backward_plain(x, dy, wqkv, bqkv, wproj, heads)
    _check_kernel_limits(x, heads)
    batch, length, dim = x.shape
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    bqkv = None if bqkv is None else bqkv.contiguous()
    f32 = torch.float32
    dx = torch.empty_like(x)
    # fp32 sums, zeroed: every block adds its clouds' share
    dwqkv = torch.zeros_like(wqkv, dtype=f32)  # keeps wqkv's strides
    dwproj = torch.zeros_like(wproj, dtype=f32)
    dbqkv = None if bqkv is None else torch.zeros(3 * dim, dtype=f32, device=x.device)
    dbproj = torch.zeros(dim, dtype=f32, device=x.device)
    if x.numel():
        dxacc = dx if x.dtype == f32 else torch.empty(x.shape, dtype=f32, device=x.device)
        lib = _build.load_library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gm3d_attn_bwd(
                x.data_ptr(), dy.data_ptr(), wqkv.data_ptr(), wqkv.stride(0), wqkv.stride(1),
                None if bqkv is None else bqkv.data_ptr(),
                wproj.data_ptr(), wproj.stride(0), wproj.stride(1),
                dxacc.data_ptr(), dx.data_ptr(),
                dwqkv.data_ptr(), dwqkv.stride(0), dwqkv.stride(1),
                None if dbqkv is None else dbqkv.data_ptr(),
                dwproj.data_ptr(), dwproj.stride(0), dwproj.stride(1), dbproj.data_ptr(),
                batch, length, dim, heads, int(x.dtype == torch.bfloat16), stream)
        _build.check_launch(rc, "fused_attention_backward")
        _build.count_launch(fused_attention_backward)
    else:
        dx.zero_()
    wt = wqkv.dtype
    return (dx, dwqkv.to(wt), None if dbqkv is None else dbqkv.to(wt),
            dwproj.to(wt), dbproj.to(wt))


class FusedAttentionFunction(torch.autograd.Function):
    """``fused_attention`` with a kernel for its backward, so that the fused
    route also serves differentiated passes (the student forward + backward).
    Saves x and the weights only; the backward recomputes from them."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, heads):
        ctx.save_for_backward(x, wqkv, bqkv, wproj)
        ctx.heads = heads
        return fused_attention(x, wqkv, bqkv, wproj, bproj, heads)

    @staticmethod
    def backward(ctx, dy):
        x, wqkv, bqkv, wproj = ctx.saved_tensors
        dx, dwqkv, dbqkv, dwproj, dbproj = fused_attention_backward(
            x, dy, wqkv, bqkv, wproj, ctx.heads)
        return dx, dwqkv, dbqkv, dwproj, dbproj, None


def fused_attention_trainable(x, wqkv, bqkv, wproj, bproj, heads: int = 6) -> torch.Tensor:
    """``fused_attention`` that autograd can differentiate."""
    return FusedAttentionFunction.apply(x, wqkv, bqkv, wproj, bproj, heads)


# launches of the CUDA kernels by this process (the plain versions never count)
fused_attention.launches = 0
fused_attention_backward.launches = 0

"""Fused mini-PointNet patch embedding, eval mode.

Port of ``gm3d_tpu/ops/patch_embed.py``. The whole ``PatchEncoder`` with its
BatchNorms folded to affine maps from the running statistics:

    p W1+b1 -> BN1 -> ReLU -> W2+b2 -> per-group max -> concat ->
    W3+b3 -> BN2 -> ReLU -> W4+b4 -> per-group max -> (B, G, C) tokens

Eval mode only and no gradient: the train step uses it for the EMA and the
frozen-teacher passes; the student's own patch embed (train-mode BatchNorm,
gradients) stays ``models.blocks.PatchEncoder``.

Two implementations of the same function:

  - ``fused_patch_embed_plain``: plain PyTorch, written the way the kernel
    computes (the concat's first half applied once per group). The CPU tests
    use it and the kernel is held against it on the card.
  - the CUDA kernel ``csrc/patch_embed.cu``, which ``fused_patch_embed``
    launches for every CUDA tensor. Its three large products (conv2, conv3's
    second half, conv4) run on the tensor cores at fp32 accuracy (3xTF32,
    ``csrc/tile_mma.cuh``; emulated on the CPU by ``ops/tile_mma.py``).

``fused_patch_embed`` takes the plain version only for tensors that lie on
the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gm3d_tpu_torch.ops import _build

# a block of the kernel owns whole groups inside 64 rows, at most 4 of them
_ROWS, _MAX_GROUPS = 64, 4
_C1, _C2, _C3 = 128, 256, 512


class PatchEmbedParams(NamedTuple):
    """Weights as (in, out) matrices, BatchNorms folded."""

    w1: torch.Tensor  # (3, 128)
    b1: torch.Tensor  # (128,)
    bn1_scale: torch.Tensor  # (128,) gamma / sqrt(var + eps)
    bn1_shift: torch.Tensor  # (128,) beta - mean * scale
    w2: torch.Tensor  # (128, 256)
    b2: torch.Tensor  # (256,)
    w3: torch.Tensor  # (512, 512)
    b3: torch.Tensor  # (512,)
    bn2_scale: torch.Tensor  # (512,)
    bn2_shift: torch.Tensor  # (512,)
    w4: torch.Tensor  # (512, C_out)
    b4: torch.Tensor  # (C_out,)


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """BatchNorm running stats -> affine (scale, shift)."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


def params_from_module(encoder) -> PatchEmbedParams:
    """Folded kernel parameters of a ``models.blocks.PatchEncoder`` (the
    counterpart of ``params_from_variables``). Detached fp32 copies: the
    ``(out, in, 1)`` convolution weights become contiguous ``(in, out)``."""
    conv1, bn1, _, conv2 = encoder.first_conv
    conv3, bn2, _, conv4 = encoder.second_conv

    def mat(conv):
        return conv.weight.detach()[..., 0].t().to(torch.float32).contiguous()

    def vec(t):
        return t.detach().to(torch.float32)

    s1, t1 = fold_bn(vec(bn1.weight), vec(bn1.bias), vec(bn1.running_mean),
                     vec(bn1.running_var), bn1.eps)
    s2, t2 = fold_bn(vec(bn2.weight), vec(bn2.bias), vec(bn2.running_mean),
                     vec(bn2.running_var), bn2.eps)
    return PatchEmbedParams(mat(conv1), vec(conv1.bias), s1, t1,
                            mat(conv2), vec(conv2.bias),
                            mat(conv3), vec(conv3.bias), s2, t2,
                            mat(conv4), vec(conv4.bias))


def _check(neighborhood: torch.Tensor, params: PatchEmbedParams) -> None:
    if neighborhood.ndim != 4 or neighborhood.shape[-1] != 3:
        raise ValueError(f"expected (B, G, S, 3) patches, got {tuple(neighborhood.shape)}")
    want = {"w1": (3, _C1), "b1": (_C1,), "bn1_scale": (_C1,), "bn1_shift": (_C1,),
            "w2": (_C1, _C2), "b2": (_C2,), "w3": (2 * _C2, _C3), "b3": (_C3,),
            "bn2_scale": (_C3,), "bn2_shift": (_C3,)}
    for name, shape in want.items():
        got = tuple(getattr(params, name).shape)
        if got != shape:
            raise ValueError(f"patch-embed parameter {name} has shape {got}, expected {shape}")
    out_dim = params.w4.shape[-1]
    if tuple(params.w4.shape) != (_C3, out_dim) or tuple(params.b4.shape) != (out_dim,):
        raise ValueError(f"w4 {tuple(params.w4.shape)} / b4 {tuple(params.b4.shape)} "
                         f"do not form a ({_C3}, C) layer")
    for name, t in params._asdict().items():
        if t.device != neighborhood.device:
            raise ValueError(f"patches on {neighborhood.device} but {name} on {t.device}")


def fused_patch_embed_plain(neighborhood: torch.Tensor, params: PatchEmbedParams,
                            matmul=torch.matmul) -> torch.Tensor:
    """Plain version. (B, G, S, 3) center-normalised patches -> (B, G, C_out)
    fp32 tokens. ``matmul`` computes the three products that the kernel takes
    to the tensor cores (``ops.tile_mma.matmul_3xtf32_plain`` emulates them)."""
    _check(neighborhood, params)
    p = PatchEmbedParams(*(t.to(torch.float32) for t in params))
    x = neighborhood.to(torch.float32)
    h1 = torch.relu((x @ p.w1 + p.b1) * p.bn1_scale + p.bn1_shift)
    h2 = matmul(h1, p.w2) + p.b2  # (B, G, S, 256)
    gmax = h2.max(dim=-2, keepdim=True).values  # (B, G, 1, 256)
    # [gmax, h2] @ W3 without the concat: the first half once per group
    h3 = matmul(h2, p.w3[_C2:]) + (gmax @ p.w3[:_C2] + p.b3)
    h3 = torch.relu(h3 * p.bn2_scale + p.bn2_shift)
    h4 = matmul(h3, p.w4)
    return h4.max(dim=-2).values + p.b4


def fused_patch_embed(neighborhood: torch.Tensor, params: PatchEmbedParams) -> torch.Tensor:
    """(B, G, S, 3) center-normalised patches -> (B, G, C_out) fp32 tokens.

    Equals ``PatchEncoder.eval()`` in fp32 up to the order of the sums. Any
    ``C_out`` is taken: where it is a multiple of 4 the kernel copies the
    weights 16 bytes at a time, else element by element (slower, same result)."""
    _check(neighborhood, params)
    if not neighborhood.is_cuda:
        return fused_patch_embed_plain(neighborhood, params)
    batch, num_groups, group_size, _ = neighborhood.shape
    if not 1 <= group_size <= _ROWS:
        raise ValueError(f"the patch-embed kernel keeps whole groups inside {_ROWS} rows "
                         f"of shared memory: group_size {group_size} does not fit")
    out_dim = params.w4.shape[-1]
    x = neighborhood.to(torch.float32).contiguous()
    p = [t.to(torch.float32).contiguous() for t in params]
    # the kernel reads parameters up to sixteen bytes at a time: a view that starts
    # elsewhere is copied
    p = [t.clone() if t.data_ptr() % 16 else t for t in p]
    out = torch.empty((batch, num_groups, out_dim), dtype=torch.float32, device=x.device)
    total = batch * num_groups
    if total and out_dim:
        lib = _build.load_library()
        groups_per_block = max(1, min(_MAX_GROUPS, _ROWS // group_size))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gm3d_patch_embed(x.data_ptr(), *(t.data_ptr() for t in p),
                                      out.data_ptr(), total, group_size, groups_per_block,
                                      out_dim, stream)
        _build.check_launch(rc, "patch_embed")
        fused_patch_embed.launches += 1
    return out


# launches of the CUDA kernel by this process (the plain version never counts)
fused_patch_embed.launches = 0

"""The exact int8 product of the w8a8 dense layers, as the torch custom op
``gm3d::int8_mm``.

No port of a TPU kernel: the JAX package computes this product with
``jax.lax.dot_general`` outside any Pallas kernel
(``gm3d_tpu/serve/quantize.py``). ``serve/quantize.py`` quantizes around it.
It is an op so that an exported program (``serve/export.py``) keeps the
route per device and not per trace: its CUDA implementation is
``torch._int_mm`` on zero-padded operands (:func:`padded_int_mm`), its CPU
implementation an int32 matmul, its fake implementation the ``(M, N)`` int32
shape. On a CUDA tensor the product never becomes a float product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm on CUDA: more than 16 rows; inner and output sizes multiples of 8
_MIN_ROWS, _ALIGN = 17, 8


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


@torch.library.custom_op("gm3d::int8_mm", mutates_args=(), device_types="cpu")
def _int8_mm_op(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """``gm3d::int8_mm`` on the CPU: an int32 matmul."""
    return torch.matmul(qx.to(torch.int32), qw.to(torch.int32).t())


@_int8_mm_op.register_kernel("cuda")
def _int8_mm_cuda(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """``gm3d::int8_mm`` on the card: ``torch._int_mm`` on padded operands
    (a copy only where N was padded, so the output is a tensor of its own)."""
    return padded_int_mm(qx, qw).contiguous()


@_int8_mm_op.register_fake
def _int8_mm_fake(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    return qx.new_empty((qx.shape[0], qw.shape[0]), dtype=torch.int32)


def int8_matmul(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """``qx (M, K) int8 @ qw (N, K).T int8 -> (M, N) int32``, exact, through
    ``torch.ops.gm3d.int8_mm``."""
    if qx.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {qx.dtype} and {qw.dtype}")
    return torch.ops.gm3d.int8_mm(qx, qw)

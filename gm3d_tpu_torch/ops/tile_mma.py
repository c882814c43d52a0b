"""The tensor-core tile product of the attention and patch-embed kernels, in
plain PyTorch.

``csrc/tile_mma.cuh`` multiplies on the H100's tensor cores, whose fp32 path
is TF32: operands keep 10 explicit mantissa bits (three decimal digits), the
sum is fp32. One TF32 pass is too coarse for the attention kernels (the EMA's
predicted losses feed a rank, and near ties flip), so every operand element
``v`` is split into two TF32 numbers,

    hi = v rounded to 11 significant bits,   lo = v - hi cut to TF32,
    v = hi + lo up to 2^-21 |v|,

and a product is three passes into the same fp32 accumulators, the small
terms first: ``A_lo B_hi + A_hi B_lo + A_hi B_hi`` ("3xTF32"). The dropped
``A_lo B_lo`` is of order 2^-22 |A| |B|, the size of fp32's own rounding. The
tensor core adds into its accumulator rounding toward zero, so the kernel
sums each 32-deep tile of k from zero and adds the tiles in plain fp32.

This module is the plain version of that arithmetic (the CPU tests hold it
against float64) and the wrapper of the kernel's unit-test entry point
``gm3d_tile_mma_test``, which ``chip_smoke.py`` launches on the card.

The fragment map, stated once here and once in the ``.cuh``. A block of 256
threads owns a 64 x 64 tile as 8 warps, 4 down x 2 across: warp ``w`` has
rows ``16 (w // 2) ..`` and columns ``32 (w % 2) ..``, four m16n8 ``mma``
tiles side by side. With ``g = lane // 4``, ``t = lane % 4``, accumulator
``reg = 4 nt + r`` (``nt`` the m16n8 tile, ``r`` the register of the
instruction's C fragment) is the output element

    i = 16 (w // 2) + g + 8 (r // 2),    j = 32 (w % 2) + 8 nt + 2 t + r % 2.
"""

from __future__ import annotations

import torch

from gm3d_tpu_torch.ops import _build

TILE = 64          # the block's output tile is at most TILE x TILE
WARPS, LANES, REGS = 8, 32, 16


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (``cvt.rna.tf32.f32``: the low 13
    mantissa bits rounded away, ties away from zero), still stored as fp32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as the tensor core reads an fp32 register: the low 13
    mantissa bits ignored."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``, both TF32 values, with ``hi + lo`` equal to ``x`` up to
    2^-21 relative, instruction for instruction as the kernel splits: ``hi``
    is ``x`` rounded to 11 significant bits by Veltkamp's splitting (fp32
    multiply and subtracts only), ``x - hi`` is exact, and the tensor core
    cuts it to TF32."""
    x = x.to(torch.float32)
    p = x * 8193.0  # 2^13 + 1
    hi = p - (p - x)
    return hi, tf32_cut(x - hi)


def matmul_tf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: what the tensor cores give without the split."""
    return torch.matmul(tf32_round(a), tf32_round(b))


def matmul_3xtf32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels compute it: operands split, three passes
    summed in fp32, the small terms first. Products of two TF32 values are
    exact in fp32, so only the order of the sum differs from the card's."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + torch.matmul(a_hi, b_hi)


def fragment_owner(warp: int, lane: int, reg: int) -> tuple[int, int]:
    """Output element (i, j) of the 64 x 64 tile that accumulator ``reg`` of
    ``lane`` in ``warp`` holds (the map of ``csrc/tile_mma.cuh``)."""
    g, t = lane // 4, lane % 4
    nt, r = reg // 4, reg % 4
    return 16 * (warp // 2) + g + 8 * (r // 2), 32 * (warp % 2) + 8 * nt + 2 * t + r % 2


def tile_product(a: torch.Tensor, b: torch.Tensor, shared_a: bool = False,
                 shared_b: bool = False, chain: bool = False,
                 wide_a: bool = False) -> torch.Tensor:
    """One (M, K) x (K, N) product, M, N <= 64, by one block of the tile
    product (fp32 out). ``a`` and ``b`` are fp32 or bf16 views of any strides:
    a transposed view costs no copy. ``shared_a`` / ``shared_b`` first copy
    that operand into a padded fp32 shared-memory buffer and multiply from
    there, as the kernels do with q, k, v and the scores (then K <= 64 too).
    ``chain`` (contiguous fp32 rows of k only) sums all of K through one chain
    of ``mma`` accumulators, which round toward zero at every link; the
    kernels sum each 32-deep tile from zero and add the tiles in plain fp32.
    ``wide_a`` is the patch embed's form (fp32, K a multiple of 32 up to 512,
    ``b`` with unit stride along its columns, say a slice of columns of an
    (in, out) weight): ``a`` goes into a (64, K + 8) shared-memory buffer and
    is multiplied from there, and the kernel's staging room holds nothing but
    ``b``'s two panels. CPU tensors take the plain version."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) and (K, N), got {tuple(a.shape)} and {tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"operands must both be fp32 or both bf16, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")
    shared = shared_a or shared_b
    if wide_a and (shared or chain or a.dtype != torch.float32 or k % 32 or k > 512
                   or b.stride(1) != 1):
        raise ValueError("the wide form is built for fp32, K a multiple of 32 up to 512, and "
                         "b with unit stride along its columns; it excludes the other forms")
    if chain and (a.dtype != torch.float32 or shared or a.stride(1) != 1 or b.stride(0) != 1):
        raise ValueError("the chained sum is built for fp32 operands in device memory "
                         "with unit stride along k only")
    if not a.is_cuda:
        return matmul_3xtf32_plain(a, b)
    if not (1 <= m <= TILE and 1 <= n <= TILE and k >= 1) or (shared and k > TILE):
        raise ValueError(f"one tile is at most {TILE} x {TILE}"
                         f"{' x ' + str(TILE) if shared else ''}, got M {m}, N {n}, K {k}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        rc = lib.gm3d_tile_mma_test(
            a.data_ptr(), a.stride(0), a.stride(1), m, b.data_ptr(), b.stride(0), b.stride(1),
            n, k, out.data_ptr(), int(a.dtype == torch.bfloat16),
            4 if wide_a else int(shared_a) + 2 * int(shared_b), int(chain),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "tile_product")
    _build.count_launch(tile_product)
    return out


tile_product.launches = 0

"""The 3xTF32 tile product of the attention kernels, on the CPU.

The CUDA kernels of ``gm3d_tpu_torch/csrc/fused_attention.cu`` multiply on
the tensor cores through ``csrc/tile_mma.cuh``. No CUDA kernel runs without a
card, so these tests hold what the kernel's arithmetic and index maps rest on:
the plain PyTorch emulation in ``gm3d_tpu_torch/ops/tile_mma.py`` (the split
into two TF32 halves, the three passes, the fragment ownership), against
float64 and against ``reference_attention``. The kernel itself is held against
float64 on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from gm3d_tpu_torch.ops import fused_attention as fa
from gm3d_tpu_torch.ops import tile_mma as tm

# chip_smoke.py's fp32 tolerance for the matrix-product kernels
TOL_FP32 = 2e-5


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the largest |want| (as chip_smoke.py)."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _normal(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("scale", [1.0, 0.05, 1e-20, 3e18])
def test_split_restores_fp32_and_both_halves_are_tf32(scale):
    x = _normal(np.random.default_rng(0), 4096, scale=scale)
    hi, lo = tm.split_tf32(x)
    for half in (hi, lo):
        assert half.dtype == torch.float32
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0  # 13 low bits clear
    gap = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((gap <= 2.0 ** -21 * x.double().abs()).all())
    # hi alone keeps three digits only: the reason for lo
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -13


def test_tf32_round_is_nearest_with_ties_away_from_zero():
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10  # spacing of TF32 in [1, 2)
    below, tie, above = (one * (1 + f * ulp) for f in (0.49, 0.5, 0.51))
    assert torch.equal(tm.tf32_round(below), one)
    assert torch.equal(tm.tf32_round(tie), one * (1 + ulp))
    assert torch.equal(tm.tf32_round(above), one * (1 + ulp))
    assert torch.equal(tm.tf32_round(torch.zeros(3)), torch.zeros(3))


@pytest.mark.parametrize("depth", [25, 64, 384])
def test_three_passes_reach_fp32_accuracy_and_one_pass_does_not(depth):
    """x ~ N(0, 1) against W ~ N(0, 0.05), the scales the kernels meet."""
    rng = np.random.default_rng(depth)
    x, w = _normal(rng, 64, depth), _normal(rng, depth, 64, scale=0.05)
    want = x.double() @ w.double()
    assert _rel_err(tm.matmul_3xtf32_plain(x, w), want) <= 2e-6
    assert _rel_err(tm.matmul_tf32_plain(x, w), want) > TOL_FP32
    # transposed views and a batch go through unchanged
    got = tm.matmul_3xtf32_plain(w.t().expand(3, 64, depth), x.t())
    assert got.shape == (3, 64, 64) and _rel_err(got[1], want.t()) <= 2e-6


def test_fragment_owner_is_a_bijection_onto_the_tile():
    owners = {}
    for warp in range(tm.WARPS):
        for lane in range(tm.LANES):
            for reg in range(tm.REGS):
                owners[tm.fragment_owner(warp, lane, reg)] = (warp, lane, reg)
    assert len(owners) == tm.WARPS * tm.LANES * tm.REGS == tm.TILE * tm.TILE
    assert set(owners) == {(i, j) for i in range(tm.TILE) for j in range(tm.TILE)}


def test_fragment_pairs_are_column_neighbours_and_warps_own_16_by_32():
    for warp in range(tm.WARPS):
        rows, cols = set(), set()
        for lane in range(tm.LANES):
            for reg in range(0, tm.REGS, 2):
                i, j = tm.fragment_owner(warp, lane, reg)
                assert j % 2 == 0  # an 8-byte atomic along j is aligned
                assert tm.fragment_owner(warp, lane, reg + 1) == (i, j + 1)
                rows.add(i)
                cols.update((j, j + 1))
        assert rows == set(range(16 * (warp // 2), 16 * (warp // 2) + 16))
        assert cols == set(range(32 * (warp % 2), 32 * (warp % 2) + 32))


def test_fragment_owner_is_the_mma_c_fragment():
    """Registers 0..3 of an m16n8 tile: rows g and g + 8, columns 2t and 2t + 1."""
    for lane in range(tm.LANES):
        g, t = lane // 4, lane % 4
        got = [tm.fragment_owner(0, lane, r) for r in range(4)]
        assert got == [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]
        assert tm.fragment_owner(3, lane, 4 * 2 + 1) == (16 + g, 32 + 16 + 2 * t + 1)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("length", [64, 39, 25, 1])
def test_attention_through_the_emulated_product_stays_within_fp32_tolerance(length, bias):
    rng = np.random.default_rng(100 + length)
    dim, heads = 384, 6
    ops = (_normal(rng, 3, length, dim), _normal(rng, 3 * dim, dim, scale=0.05).t(),
           _normal(rng, 3 * dim, scale=0.1) if bias else None,
           _normal(rng, dim, dim, scale=0.05).t(), _normal(rng, dim, scale=0.1))
    want = fa.reference_attention(*ops, heads)
    got = fa.reference_attention(*ops, heads, matmul=tm.matmul_3xtf32_plain)
    assert _rel_err(got, want) <= TOL_FP32
    if length > 1:  # one token attends to itself alone: softmax is exactly 1
        one_pass = fa.reference_attention(*ops, heads, matmul=tm.matmul_tf32_plain)
        assert _rel_err(one_pass, want) > TOL_FP32


def test_tile_product_checks_its_operands_and_counts_no_launch_on_the_cpu():
    rng = np.random.default_rng(1)
    a, b = _normal(rng, 25, 39), _normal(rng, 39, 64)
    before = tm.tile_product.launches
    got = tm.tile_product(a, b)
    assert torch.equal(got, tm.matmul_3xtf32_plain(a, b))
    assert tm.tile_product.launches == before
    with pytest.raises(ValueError, match=r"\(M, K\) and \(K, N\)"):
        tm.tile_product(a, a)
    with pytest.raises(ValueError, match="both"):
        tm.tile_product(a, b.to(torch.bfloat16))

"""The patch embed through the emulated tensor-core product, on the CPU.

``gm3d_tpu_torch/csrc/patch_embed.cu`` takes its three large products (conv2,
the second half of conv3, conv4) to the tensor cores through
``csrc/tile_mma.cuh`` as three TF32 passes on split operands. No CUDA kernel
runs without a card, so these tests hold the arithmetic: the plain version of
the patch embed with ``ops/tile_mma.py``'s emulation of that product in place
of ``torch.matmul`` must stay within the tolerance that ``chip_smoke.py``
holds the kernel to on the card, and one TF32 pass must not.
"""

import numpy as np
import pytest
import torch

from gm3d_tpu_torch.models.blocks import PatchEncoder
from gm3d_tpu_torch.ops import patch_embed as pe
from gm3d_tpu_torch.ops import tile_mma as tm

# chip_smoke.py's fp32 tolerance for the matrix-product kernels
TOL_FP32 = 2e-5

# (B, G, S, 3): the train step's groups, an odd shape with four groups a block,
# and one whose last block of two groups is ragged
SHAPES = [(2, 64, 32, 3), (3, 5, 7, 3), (3, 5, 32, 3)]


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the largest |want| (as chip_smoke.py)."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def _encoder(seed: int, out_dim: int) -> PatchEncoder:
    """Activations of order one, every bias non-zero (conv2's too), BatchNorm
    statistics away from (0, 1)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return torch.from_numpy((rng.standard_normal(tuple(shape)) * scale).astype(np.float32))

    enc = PatchEncoder(out_dim)
    with torch.no_grad():
        for m in enc.modules():
            if hasattr(m, "running_mean"):
                m.running_mean.copy_(normal(m.running_mean.shape, 0.3))
                m.running_var.copy_(normal(m.running_var.shape, 0.3).abs() + 0.5)
                m.weight.copy_(normal(m.weight.shape, 0.3).abs() + 0.5)
                m.bias.copy_(normal(m.bias.shape, 0.2))
            elif hasattr(m, "weight"):  # a per-point convolution, (out, in, 1)
                m.weight.copy_(normal(m.weight.shape, m.weight.shape[1] ** -0.5))
                m.bias.copy_(normal(m.bias.shape, 0.2))
    return enc.eval()


def _case(shape, out_dim):
    enc = _encoder(sum(shape) + out_dim, out_dim)
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32))
    return enc, pe.params_from_module(enc), x


@pytest.mark.parametrize("out_dim", [384, 30])
@pytest.mark.parametrize("shape", SHAPES)
def test_three_passes_keep_the_tokens_within_the_fp32_tolerance(shape, out_dim):
    enc, params, x = _case(shape, out_dim)
    assert float(params.b2.abs().min()) > 0.0
    want = pe.fused_patch_embed_plain(x, params)
    got = pe.fused_patch_embed_plain(x, params, matmul=tm.matmul_3xtf32_plain)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:2] + (out_dim,)
    assert _rel_err(got, want) <= TOL_FP32
    with torch.no_grad():
        assert _rel_err(got, enc(x)) <= TOL_FP32


@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_pass_does_not(shape):
    _, params, x = _case(shape, 384)
    want = pe.fused_patch_embed_plain(x, params)
    one_pass = pe.fused_patch_embed_plain(x, params, matmul=tm.matmul_tf32_plain)
    assert _rel_err(one_pass, want) > TOL_FP32


def test_the_default_product_is_torch_matmul():
    _, params, x = _case((3, 5, 7, 3), 48)
    assert torch.equal(pe.fused_patch_embed_plain(x, params),
                       pe.fused_patch_embed_plain(x, params, matmul=torch.matmul))
    # a CPU tensor takes the plain version with that product and counts no launch
    before = pe.fused_patch_embed.launches
    assert torch.equal(pe.fused_patch_embed(x, params), pe.fused_patch_embed_plain(x, params))
    assert pe.fused_patch_embed.launches == before


@pytest.mark.parametrize("depth", [128, 256, 512])
def test_the_patch_embed_form_of_the_tile_product_on_the_cpu(depth):
    """K 128, 256, 512 against a slice of columns of an (in, out) weight."""
    rng = np.random.default_rng(depth)
    a = torch.from_numpy(rng.standard_normal((39, depth)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((depth, 384)) * 0.05).astype(np.float32))
    b = w[:, 64:128]
    before = tm.tile_product.launches
    got = tm.tile_product(a, b, wide_a=True)
    assert tm.tile_product.launches == before
    assert _rel_err(got, a.double() @ b.double()) <= 2e-6
    with pytest.raises(ValueError, match="wide form"):
        tm.tile_product(a[:, :depth - 1], b[:depth - 1], wide_a=True)
    with pytest.raises(ValueError, match="wide form"):
        tm.tile_product(a, b, wide_a=True, shared_b=True)
    with pytest.raises(ValueError, match="wide form"):
        tm.tile_product(a, w.t()[:64].t()[:, ::2], wide_a=True)

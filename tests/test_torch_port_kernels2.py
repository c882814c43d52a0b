"""The plain versions of the patch-embed and attention kernels against the
JAX package's Pallas kernels (interpret mode), on the CPU.

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds them
against these plain versions there. Here the plain versions (which the
wrappers take for CPU tensors) are held against ``gm3d_tpu``: same numpy
inputs on both sides.

Tolerances: fp32 ``atol=2e-5`` on values of order one (same formulas, other
summation order); gradients ``rtol=1e-4`` of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gm3d_tpu.models import blocks as jb
from gm3d_tpu.ops import fused_attention as jfa
from gm3d_tpu.ops import patch_embed as jpe
from gm3d_tpu_torch.ckpt.torch_import import state_dict_from_flax
from gm3d_tpu_torch.models import blocks as tb
from gm3d_tpu_torch.ops import fused_attention as tfa
from gm3d_tpu_torch.ops import patch_embed as tpe

_PATCH = {"first_conv.0": ("conv1", "conv"), "first_conv.1": ("bn1", "bn"),
          "first_conv.3": ("conv2", "conv"), "second_conv.0": ("conv3", "conv"),
          "second_conv.1": ("bn2", "bn"), "second_conv.3": ("conv4", "conv")}
_FIELDS = tpe.PatchEmbedParams._fields


def _patch_variables(seed, out_dim, conv2_bias=True):
    """Numpy variables of a flax PatchEncoder: no leaf is trivial."""
    rng = np.random.default_rng(seed)
    jmodule = jb.PatchEncoder(out_dim)
    shapes = jax.eval_shape(jmodule.init, jax.random.key(0), jnp.zeros((2, 4, 8, 3)))

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name, module = path[-1].key, path[-2].key
        if name == "var":
            return 1.0 + 0.5 * np.abs(noise)
        if name == "kernel":
            return noise / np.sqrt(s.shape[0])
        if name == "bias" and module == "conv2" and not conv2_bias:
            return np.zeros(s.shape, np.float32)
        return (1.0 if name == "scale" else 0.0) + 0.2 * noise

    return jmodule, jax.tree_util.tree_map_with_path(leaf, shapes)


def _torch_params(variables):
    enc = tb.PatchEncoder(variables["params"]["conv4"]["bias"].shape[0])
    enc.load_state_dict(state_dict_from_flax(variables, _PATCH), strict=True)
    return enc.eval(), tpe.params_from_module(enc)


@pytest.mark.parametrize("shape", [(2, 16, 8, 3), (3, 5, 7, 3)])
def test_patch_embed_plain_equals_pallas_kernel(shape):
    # The Pallas kernel never adds conv2's bias (its other biases it does), so
    # the two can only be compared where that bias is zero, as flax
    # initialises it.
    _, variables = _patch_variables(0, 48, conv2_bias=False)
    x = (np.random.default_rng(1).standard_normal(shape) * 0.3).astype(np.float32)
    want = np.asarray(jpe.fused_patch_embed(
        jnp.asarray(x), jpe.params_from_variables(variables, prefix=()), interpret=True))
    _, params = _torch_params(variables)
    got = tpe.fused_patch_embed(torch.from_numpy(x), params)  # CPU tensor: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:2] + (48,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    for name, a, b in zip(_FIELDS, params, jpe.params_from_variables(variables, prefix=())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 16, 8, 3), (3, 5, 7, 3)])
def test_patch_embed_plain_equals_patch_encoder_eval(shape):
    """With every bias non-trivial the plain version equals both packages'
    ``PatchEncoder`` in eval mode (running statistics)."""
    jmodule, variables = _patch_variables(2, 48)
    x = (np.random.default_rng(3).standard_normal(shape) * 0.3).astype(np.float32)
    enc, params = _torch_params(variables)
    got = tpe.fused_patch_embed_plain(torch.from_numpy(x), params).numpy()
    with torch.no_grad():
        module = enc(torch.from_numpy(x)).numpy()
    flax = np.asarray(jmodule.apply(variables, jnp.asarray(x), True))
    np.testing.assert_allclose(got, module, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, flax, atol=2e-5, rtol=0)


def test_patch_embed_rejects_wrong_shapes():
    _, variables = _patch_variables(4, 48)
    _, params = _torch_params(variables)
    with pytest.raises(ValueError, match="B, G, S, 3"):
        tpe.fused_patch_embed(torch.zeros(2, 8, 3), params)
    with pytest.raises(ValueError, match="w2"):
        tpe.fused_patch_embed(torch.zeros(1, 2, 4, 3), params._replace(w2=torch.zeros(128, 64)))


def _attention_operands(seed, batch, length, dim=48, bias=True):
    rng = np.random.default_rng(seed)

    def r(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (r(batch, length, dim, scale=1.0), r(dim, 3 * dim, scale=0.15),
            r(3 * dim, scale=0.1) if bias else np.zeros(3 * dim, np.float32),
            r(dim, dim, scale=0.15), r(dim, scale=0.1))


@pytest.mark.parametrize("length", [8, 5])
@pytest.mark.parametrize("bias", [True, False])
def test_reference_attention_equals_pallas_kernel(length, bias):
    ops = _attention_operands(0, 4, length, bias=bias)
    want = np.asarray(jfa.fused_attention(*map(jnp.asarray, ops), heads=2, block_batch=2,
                                          interpret=True))
    x, wqkv, bqkv, wproj, bproj = map(torch.from_numpy, ops)
    got = tfa.fused_attention(x, wqkv, bqkv if bias else None, wproj, bproj, heads=2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfa.reference_attention(*map(jnp.asarray, ops), heads=2)),
        atol=2e-5, rtol=0)


@pytest.mark.parametrize("length", [8, 5])
def test_attention_gradients_equal_pallas_backward(length):
    """dx and the four weight gradients of a weighted sum of the outputs:
    torch autograd of the plain version, the port's ``FusedAttentionFunction``
    (CPU route) and ``jax.grad`` through the Pallas backward kernel."""
    ops = _attention_operands(1, 4, length)
    weight = np.random.default_rng(2).standard_normal(ops[0].shape).astype(np.float32)

    def jloss(x, wqkv, bqkv, wproj, bproj):
        y = jfa.fused_attention_trainable(x, wqkv, bqkv, wproj, bproj, 2, 2, True)
        return jnp.sum(y * weight)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ops))
    for fn in (tfa.reference_attention, tfa.fused_attention_trainable):
        leaves = [torch.from_numpy(o).requires_grad_(True) for o in ops]
        (fn(*leaves, 2) * torch.from_numpy(weight)).sum().backward()
        for name, leaf, w in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj"), leaves, want):
            w = np.asarray(w)
            np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_fused_attention_function_matches_autograd_without_qkv_bias():
    """The Function's backward (here the plain backward) against autograd of
    the plain forward, transposed-view weights as ``Attention`` hands them
    over, in float64-free fp32: every gradient to 1e-5 of its largest entry."""
    x, wqkv, _, wproj, bproj = map(torch.from_numpy, _attention_operands(3, 3, 7, bias=False))
    lin_qkv, lin_proj = wqkv.t().contiguous(), wproj.t().contiguous()  # (out, in) storage
    grads = []
    for fn in (tfa.reference_attention, tfa.fused_attention_trainable):
        leaves = [t.clone().requires_grad_(True) for t in (x, lin_qkv, lin_proj, bproj)]
        y = fn(leaves[0], leaves[1].t(), None, leaves[2].t(), leaves[3], 2)
        y.pow(2).sum().backward()
        grads.append([leaf.grad for leaf in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    dx, dwqkv, dbqkv, dwproj, dbproj = tfa.fused_attention_backward(
        x, torch.ones_like(x), wqkv, None, wproj, 2)
    assert dbqkv is None and dwqkv.shape == wqkv.shape and dbproj.shape == bproj.shape


def test_attention_wrappers_reject_bad_operands():
    x, wqkv, bqkv, wproj, bproj = map(torch.from_numpy, _attention_operands(4, 2, 4))
    with pytest.raises(ValueError, match="heads"):
        tfa.fused_attention(x, wqkv, bqkv, wproj, bproj, heads=5)
    with pytest.raises(ValueError, match="wqkv"):
        tfa.fused_attention(x, wqkv.t(), bqkv, wproj, bproj, heads=2)
    with pytest.raises(ValueError, match="bfloat16|float32"):
        tfa.fused_attention(x, wqkv.to(torch.bfloat16), bqkv, wproj, bproj, heads=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_module_inside_scope_equals_outside(dtype, qkv_bias):
    torch.manual_seed(0)
    attn = tb.Attention(48, 2, dtype=dtype, qkv_bias=qkv_bias)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn_like(p) * 0.15)
    x = torch.randn(3, 7, 48)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    outs, grads = [], []
    for fused in (False, True):
        leaf = x.clone().requires_grad_(True)
        attn.zero_grad()
        with tb.fused_attention_scope(fused):
            y = attn(leaf)
        y.to(torch.float32).pow(2).sum().backward()
        outs.append(y)
        grads.append([leaf.grad] + [p.grad.clone() for p in attn.parameters()])
    assert outs[0].dtype == outs[1].dtype == dtype
    torch.testing.assert_close(outs[0].float(), outs[1].float(), rtol=0, atol=tol)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=tol * max(1.0, float(b.abs().max())))


def test_scope_leaves_masked_attention_and_the_serving_path_alone(monkeypatch):
    calls = []
    monkeypatch.setattr(tb, "fused_attention_trainable",
                        lambda *a: calls.append(1) or tfa.fused_attention_trainable(*a))
    attn = tb.Attention(48, 2).eval()
    x = torch.randn(2, 5, 48)
    attn(x)  # outside the scope: plain tensor code
    with tb.fused_attention_scope(True):
        attn(x, attn_mask=torch.ones(2, 5, 5, dtype=torch.bool))  # a mask declines the route
        assert not calls
        attn(x)
        assert len(calls) == 1
        with tb.fused_attention_scope(False):
            attn(x)
    attn(x)
    assert len(calls) == 1
    dropping = tb.Attention(48, 2, attn_drop=0.1).train()
    with tb.fused_attention_scope(True):
        dropping(x)  # live dropout declines the route
        assert len(calls) == 1
        dropping.eval()(x)
        assert len(calls) == 2

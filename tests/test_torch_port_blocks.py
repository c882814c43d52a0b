"""gm3d_tpu_torch building blocks against their flax counterparts (CPU).

The flax module's variables are made with numpy from a seed (biases, norm
scales and BatchNorm running statistics are non-trivial), carried across with ``state_dict_from_flax`` and loaded with ``strict=True``;
both sides then see the same numpy input.

Tolerances: fp32 ``atol=1e-5`` (same formulas, different summation order in
the matmuls); bf16 ``atol=3e-2`` (the two frameworks round to bf16 at the same
places by construction, the remainder is summation order amplified by the
8-bit mantissa).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gm3d_tpu.models import blocks as jb
from gm3d_tpu.models.point_transformer import ClsHead as JClsHead
from gm3d_tpu_torch.ckpt.torch_import import state_dict_from_flax
from gm3d_tpu_torch.models import blocks as tb
from gm3d_tpu_torch.models.point_transformer import ClsHead

DIM, HEADS, DEPTH = 48, 2, 2
_BLOCK = {"norm1": ("norm1", "ln"), "norm2": ("norm2", "ln"),
          "attn.qkv": ("attn/qkv", "linear"), "attn.proj": ("attn/proj", "linear"),
          "mlp.fc1": ("mlp/fc1", "linear"), "mlp.fc2": ("mlp/fc2", "linear")}
_STACK = {f"blocks.{{i}}.{k}": (f"block{{i}}/{v}", kind) for k, (v, kind) in _BLOCK.items()}
_PATCH = {"first_conv.0": ("conv1", "conv"), "first_conv.1": ("bn1", "bn"),
          "first_conv.3": ("conv2", "conv"), "second_conv.0": ("conv3", "conv"),
          "second_conv.1": ("bn2", "bn"), "second_conv.3": ("conv4", "conv")}
_POS = {"0": ("fc1", "linear"), "2": ("fc2", "linear")}
_HEAD = {"0": ("fc1", "linear"), "1": ("bn1", "bn"), "4": ("fc2", "linear"),
         "5": ("bn2", "bn"), "8": ("fc3", "linear")}


def _variables(jmodule, init_args, seed, noise_std=0.1):
    """Seeded numpy variables in the tree ``jmodule.init`` would give (shapes
    by ``jax.eval_shape``, so nothing is computed): weights and biases are
    noise, norm scales 1 + noise, running variances positive, so that no
    parameter is trivial."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return 1.0 + 0.5 * np.abs(noise)
        return (1.0 if name == "scale" else 0.0) + noise_std * noise

    shapes = jax.eval_shape(jmodule.init, jax.random.key(0), *init_args)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _carry(jmodule, init_args, tmodule, table, seed=0, noise_std=0.1):
    variables = _variables(jmodule, init_args, seed, noise_std)
    tmodule.load_state_dict(state_dict_from_flax(variables, table), strict=True)
    return variables, tmodule.eval()


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, atol):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol, rtol=0)


def test_block_matches_flax():
    x = _x(1, 3, 17, DIM)
    jm = jb.Block(DIM, HEADS)
    v, tm = _carry(jm, (jnp.asarray(x),), tb.Block(DIM, HEADS), _BLOCK)
    _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)), 1e-5)


def test_block_attention_mask_matches_flax():
    x = _x(2, 2, 9, DIM)
    mask = np.random.default_rng(3).random((2, 9, 9)) > 0.4
    mask |= np.eye(9, dtype=bool)[None]
    jm = jb.Block(DIM, HEADS)
    v, tm = _carry(jm, (jnp.asarray(x),), tb.Block(DIM, HEADS), _BLOCK)
    want = jm.apply(v, jnp.asarray(x), True, jnp.asarray(mask))
    _close(tm(torch.from_numpy(x), torch.from_numpy(mask)), want, 1e-5)
    unmasked = jm.apply(v, jnp.asarray(x))
    assert np.abs(np.asarray(want) - np.asarray(unmasked)).max() > 1e-3


def test_transformer_encoder_adds_pos_at_every_block():
    x, pos = _x(4, 2, 17, DIM), _x(5, 2, 17, DIM)
    jm = jb.TransformerEncoder(DIM, DEPTH, HEADS, drop_path_rate=0.1)
    v, tm = _carry(jm, (jnp.asarray(x), jnp.asarray(pos)),
                   tb.TransformerEncoder(DIM, DEPTH, HEADS, drop_path_rate=0.1), _STACK)
    got = tm(torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, jm.apply(v, jnp.asarray(x), jnp.asarray(pos)), 1e-5)
    # pos only at the stem would give another answer
    stem_only = tm(torch.from_numpy(x + pos), torch.zeros(2, 17, DIM))
    assert (got - stem_only).abs().max() > 1e-3


@pytest.mark.parametrize("return_tokens", [0, 5])
def test_transformer_decoder_matches_flax(return_tokens):
    x, pos = _x(6, 2, 12, DIM), _x(7, 2, 12, DIM)
    jm = jb.TransformerDecoder(DIM, DEPTH, HEADS)
    table = {**_STACK, "norm": ("norm", "ln")}
    v, tm = _carry(jm, (jnp.asarray(x), jnp.asarray(pos)),
                   tb.TransformerDecoder(DIM, DEPTH, HEADS), table)
    _close(tm(torch.from_numpy(x), torch.from_numpy(pos), return_tokens),
           jm.apply(v, jnp.asarray(x), jnp.asarray(pos), return_tokens), 1e-5)


def test_patch_encoder_eval_with_running_stats_matches_flax():
    x = 0.3 * _x(8, 2, 6, 8, 3)
    jm = jb.PatchEncoder(DIM)
    v, tm = _carry(jm, (jnp.asarray(x),), tb.PatchEncoder(DIM), _PATCH)
    assert np.abs(v["batch_stats"]["bn1"]["mean"]).max() > 0.01
    _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x), True), 1e-5)
    sd = tm.state_dict()
    assert sd["first_conv.0.weight"].shape == (128, 3, 1)  # Conv1d layout kept
    assert sd["second_conv.3.weight"].shape == (DIM, 512, 1)


def test_pos_embed_matches_flax():
    c = _x(9, 3, 16, 3)
    jm = jb.PosEmbedMLP(DIM)
    v, tm = _carry(jm, (jnp.asarray(c),), tb.PosEmbedMLP(DIM), _POS)
    _close(tm(torch.from_numpy(c)), jm.apply(v, jnp.asarray(c)), 1e-5)


def test_cls_head_eval_matches_flax():
    x = _x(10, 4, 2 * DIM)
    jm = JClsHead(7)
    v, tm = _carry(jm, (jnp.asarray(x),), ClsHead(2 * DIM, 7), _HEAD)
    _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x), True), 1e-5)


def test_batchnorm_training_keeps_torch_running_stat_rules():
    x = _x(11, 4, 5, 6, 16) * 2.0 + 1.0
    jm = jb.TorchBatchNorm(use_running_average=False, momentum=0.9)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    want, upd = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tm = tb.TorchBatchNorm(16).train()
    _close(tm(torch.from_numpy(x)), want, 1e-5)
    _close(tm.running_mean, upd["batch_stats"]["mean"], 1e-6)
    _close(tm.running_var, upd["batch_stats"]["var"], 1e-5)


def test_drop_path_is_identity_in_eval_and_scales_in_training():
    x = torch.ones(64, 3, 4)
    assert tb.drop_path(x, 0.5, True) is x
    assert tb.drop_path(x, 0.0, False) is x
    g = torch.Generator().manual_seed(0)
    y = tb.drop_path(x, 0.5, False, g)
    rows = y.reshape(64, -1)
    assert set(rows.unique().tolist()) == {0.0, 2.0}
    assert (rows.min(dim=1).values == rows.max(dim=1).values).all()  # per sample


def test_bf16_encoder_stack_matches_flax():
    # inputs and weight noise sized so that |values| stay below 2, where a
    # bf16 ulp is 2^-7: the tolerance is then a few ulps of the residual stream
    x, pos = 0.5 * _x(12, 2, 17, DIM), 0.1 * _x(13, 2, 17, DIM)
    jm = jb.TransformerEncoder(DIM, DEPTH, HEADS, dtype=jnp.bfloat16)
    v, tm = _carry(jm, (jnp.asarray(x), jnp.asarray(pos)),
                   tb.TransformerEncoder(DIM, DEPTH, HEADS, dtype=torch.bfloat16), _STACK,
                   noise_std=0.03)
    xb, pb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos, jnp.bfloat16)
    want = jm.apply(v, xb, pb)
    got = tm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())  # params stay fp32
    assert np.abs(np.asarray(want, np.float32)).max() < 2.5
    _close(got, want, 3e-2)


def test_bf16_patch_encoder_matches_flax():
    x = 0.3 * _x(14, 2, 6, 8, 3)
    jm = jb.PatchEncoder(DIM, dtype=jnp.bfloat16)
    v, tm = _carry(jm, (jnp.asarray(x),), tb.PatchEncoder(DIM, dtype=torch.bfloat16), _PATCH)
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _close(got, jm.apply(v, jnp.asarray(x), True), 3e-2)

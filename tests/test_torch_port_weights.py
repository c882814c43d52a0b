"""``state_dict_from_flax`` against the JAX package's own exporter.

The port's weight carrier must name and lay out every tensor exactly as
``gm3d_tpu.ckpt.torch_import.export_torch_checkpoint`` does (key for key,
value for value), and the port's models must load the result with
``strict=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gm3d_tpu.ckpt import torch_import as jti
from gm3d_tpu.models import GM3DStudent as JGM3DStudent
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.models import PointTransformer as JPointTransformer
from gm3d_tpu_torch.ckpt import torch_import as tti
from gm3d_tpu_torch.models import GM3DStudent, PointMAE, PointTransformer

SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48)
DEC = dict(decoder_depth=1, decoder_num_heads=2)
PTS = jnp.zeros((2, 128, 3), jnp.float32)
MASK = jnp.zeros((2, 16), bool).at[:, :9].set(True)


def _cases():
    return {
        "point_transformer": (
            JPointTransformer(cls_dim=5, **SMALL), (PTS,),
            jti.POINT_TRANSFORMER_MAP, tti.POINT_TRANSFORMER_MAP,
            lambda: PointTransformer(cls_dim=5, **SMALL)),
        "point_mae": (
            JPointMAE(**SMALL, **DEC), (PTS, MASK, 9),
            jti.POINT_MAE_MAP, tti.POINT_MAE_MAP,
            lambda: PointMAE(**SMALL, **DEC)),
        "gm3d_student": (
            JGM3DStudent(**SMALL, **DEC), (PTS, MASK, 9),
            jti.GM3D_STUDENT_MAP, tti.GM3D_STUDENT_MAP,
            lambda: GM3DStudent(**SMALL, **DEC)),
        "gm3d_student_usual": (
            JGM3DStudent(mode="usual", **SMALL, **DEC), (PTS, MASK, 9),
            jti.GM3D_STUDENT_MAP, tti.GM3D_STUDENT_MAP,
            lambda: GM3DStudent(mode="usual", **SMALL, **DEC)),
    }


def _numpy_variables(jmodel, init_args, seed):
    """Seeded numpy variables in the tree ``jmodel.init`` would give (shapes
    by ``jax.eval_shape``, so nothing is computed): no two tensors are equal
    by accident of initialisation."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, *init_args), jax.random.key(0))
    return jax.tree_util.tree_map(
        lambda s: (0.5 + np.abs(rng.standard_normal(s.shape))).astype(np.float32), shapes)


@pytest.mark.parametrize("case", sorted(_cases()))
def test_state_dict_equals_jax_exporter(case):
    jmodel, init_args, jtable, ttable, _ = _cases()[case]
    variables = _numpy_variables(jmodel, init_args, 1)
    want = jti.export_torch_checkpoint(variables, jtable)
    got = tti.state_dict_from_flax(variables, ttable)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert isinstance(got[key], torch.Tensor) and got[key].dtype == torch.float32, key
        assert tuple(got[key].shape) == value.shape, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("case", sorted(_cases()))
def test_strict_load_and_round_trip(case):
    jmodel, init_args, _, ttable, build = _cases()[case]
    variables = _numpy_variables(jmodel, init_args, 2)
    sd = tti.state_dict_from_flax(variables, ttable)
    model = build()
    model.load_state_dict(sd, strict=True)  # raises on a missing or unexpected key
    loaded = model.state_dict()
    for key, value in sd.items():
        assert torch.equal(loaded[key], value), key
    extra = set(loaded) - set(sd)
    assert all(k.endswith("num_batches_tracked") for k in extra), extra


def test_reference_names_and_layouts():
    jmodel, init_args, _, ttable, _ = _cases()["point_transformer"]
    sd = tti.state_dict_from_flax(_numpy_variables(jmodel, init_args, 3), ttable)
    assert sd["blocks.blocks.1.attn.qkv.weight"].shape == (144, 48)
    assert "blocks.blocks.0.attn.qkv.bias" not in sd  # qkv has no bias
    assert sd["encoder.first_conv.0.weight"].shape == (128, 3, 1)  # Conv1d axis kept
    assert sd["encoder.first_conv.1.running_var"].shape == (128,)
    assert sd["cls_head_finetune.8.weight"].shape == (5, 256)
    assert sd["cls_token"].shape == (1, 1, 48) and sd["cls_pos"].shape == (1, 1, 48)
    assert sd["norm_p.weight"].shape == (48,)
    jmodel, init_args, _, ttable, _ = _cases()["gm3d_student"]
    sd = tti.state_dict_from_flax(_numpy_variables(jmodel, init_args, 3), ttable)
    for key in ("mask_token", "mask_token_loss_pred", "MAE_encoder.norm_p.bias",
                "increase_dim_2.1.running_mean", "MAE_decoder_loss_pred.norm.weight",
                "increase_dim_just_network_without_feature.0.weight"):
        assert key in sd, key


def test_unknown_module_is_an_error():
    with pytest.raises(KeyError, match="no torch name"):
        tti.state_dict_from_flax(
            {"params": {"mystery": {"kernel": np.zeros((2, 2), np.float32)}}},
            tti.POINT_TRANSFORMER_MAP)


def test_load_torch_file_strips_prefixes(tmp_path):
    sd = {"module.base_model.cls_token": torch.ones(1, 1, 4)}
    path = tmp_path / "w.pth"
    torch.save({"base_model": sd}, path)
    assert list(tti.load_torch_file(str(path))) == ["cls_token"]

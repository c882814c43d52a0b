"""The port's dynamic-int8 quantization against the JAX package's (CPU).

``gm3d_tpu_torch/serve/quantize.py`` against ``gm3d_tpu/serve/quantize.py``:
the per-channel weight quantization, the int8 product's int32
accumulations, a classifier's forward under ``quantized_dense()``, the int8
artifact through the export CLI and the server, and the GM3D step with
``quantize_ema``. Small models (depth 1 - 2, widths 16 - 48), numpy inputs
from a seed, weights carried across with ``state_dict_from_flax``.

Tolerances: int8 tensors and int32 accumulations EQUAL; scales within 1 ulp;
a w8a8 layer's output within 1e-6 relative; the quantized classifier's logits
within ``QLOGIT_TOL`` of the logit range of the JAX package's (upstream fp32
differences can move a value across a rounding boundary of the next layer's
per-token int8, see the test); the quantized step's metrics ``rtol=2e-4``, the
step test's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_threads import torch_at_one_thread  # noqa: F401
from gm3d_tpu.models import PointTransformer as JPointTransformer
from gm3d_tpu.serve import export as jexport
from gm3d_tpu.serve import quantize as jq
from gm3d_tpu_torch.ckpt import POINT_TRANSFORMER_MAP, state_dict_from_flax
from gm3d_tpu_torch.cli import export_model
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.models import GM3DStudent, PointMAE
from gm3d_tpu_torch.models.blocks import Attention, Dense, LayerNorm, fused_attention_scope
from gm3d_tpu_torch.serve import (ServingModel, build_classifier_fn, build_feature_fn, build_seg_fn,
                                  load_artifact)
from gm3d_tpu_torch.serve import quantize as q

NPOINTS, CLS = 128, 7
SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48)
# the bound the test holds the gap to; on its inputs the gap measured 2.08e-7
# of the range (no rounding flip among them)
QLOGIT_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


# the (K, N) of every dense layer the small classifier has, and the kinds of
# shape the card pads: K = 3 (the patch embed, the positions), N = 7, 15, 50
SHAPES = [(5, 3, 128), (64, 48, 144), (16, 256, 7), (3, 256, 15), (40, 192, 50), (33, 384, 1152)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_layer_equals_the_jax_one(shape):
    """``quantize_kernel``: int8 equal, scales within 1 ulp; the per-token
    activation quantization equal; the int32 accumulations of the product
    EQUAL to ``jax.lax.dot_general``'s; the rescaled output within 1e-6."""
    m, k, n = shape
    rng = _rng(sum(shape))
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32) * 3.0
    bias = rng.standard_normal(n).astype(np.float32)
    qw, sw = q.quantize_kernel(torch.from_numpy(w))
    jqw, jsw = jq.quantize_kernel(jnp.asarray(w.T))
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw).T)
    np.testing.assert_array_max_ulp(sw.numpy(), np.asarray(jsw), maxulp=1)
    qx, sx = q.quantize_rows(torch.from_numpy(x))
    jsx = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True), 1e-12) / 127.0
    jqx = jnp.clip(jnp.round(x / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jqx))
    acc = q.int8_matmul(qx, qw)
    jacc = jax.lax.dot_general(jqx, jqw, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    got = q.int8_linear(torch.from_numpy(x), qw, sw, torch.from_numpy(bias), torch.float32)
    want = jq._int8_dense(jnp.asarray(x), jqw, jsw, jnp.asarray(bias), jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES + [(17, 8, 8), (1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_the_padding_for_int_mm_is_exact(shape):
    """``padded_int_mm`` hands ``torch._int_mm`` only shapes it takes on the
    card (more than 16 rows, K and N multiples of 8) and returns the unpadded
    product exactly. The stand-in checks the shapes and multiplies in int32."""
    m, k, n = shape
    rng = _rng(7 + sum(shape))
    qx = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    seen = []

    def int_mm(a, b):
        assert a.dtype == b.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0, (a.shape, b.shape)
        seen.append((tuple(a.shape), tuple(b.shape)))
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))

    got = q.padded_int_mm(qx, qw, mm=int_mm)
    assert len(seen) == 1 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), (qx.long() @ qw.long().t()).numpy())


def test_a_cuda_tensor_takes_int_mm_and_never_a_float_product(monkeypatch):
    """On a CUDA tensor the int8 product goes to ``torch._int_mm``: a dense
    layer's product is the op ``gm3d::int8_mm``, sent here to the op's CUDA
    kernel (the dispatcher's CUDA key) with tensors of the CPU, and that kernel
    hands it to ``torch._int_mm`` (a stand-in that raises)."""

    class Reached(Exception):
        pass

    def int_mm(a, b):
        assert a.dtype == b.dtype == torch.int8
        raise Reached

    op = torch.ops.gm3d.int8_mm.default
    cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    monkeypatch.setattr(torch, "_int_mm", int_mm)
    monkeypatch.setattr(torch.ops.gm3d, "int8_mm", lambda qx, qw: op.redispatch(cuda, qx, qw))
    layer = Dense(3, 15)
    with pytest.raises(Reached), q.quantized_dense():
        layer(torch.randn(4, 3))


@functools.lru_cache(maxsize=None)
def _classifier():
    jmodel = JPointTransformer(cls_dim=CLS, drop_path_rate=0.0, **SMALL)
    rng = _rng(3)

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return 1.0 + 0.5 * np.abs(noise)
        if name == "kernel":
            return noise / np.sqrt(s.shape[0])
        return (1.0 if name == "scale" else 0.0) + 0.1 * noise

    shapes = jax.eval_shape(lambda key: jmodel.init(key, jnp.zeros((2, NPOINTS, 3))),
                            jax.random.key(0))
    return jmodel, jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_classifier():
    jmodel, variables = _classifier()
    model = build_model_from_cfg(dict(NAME="PointTransformer", cls_dim=CLS, drop_path_rate=0.0,
                                      **SMALL))
    model.load_state_dict(state_dict_from_flax(variables, POINT_TRANSFORMER_MAP), strict=True)
    return model.eval()


def test_the_quantized_classifier_tracks_the_jax_one():
    """The classifier's forward under ``quantized_dense()`` in both packages:
    every dense layer int8. The fp32 forwards agree to about 1e-6; where such
    a difference puts a value on the other side of a .5 of the next layer's
    int8 rounding, that layer's output moves by one step of its scale, so the
    gap is held to ``QLOGIT_TOL`` of the logit range (measured: see the
    constant) and the top-1 classes must agree. Each is within 0.15 of the
    range of its own fp32 logits (``tests/test_quantize.py``'s bound)."""
    jmodel, variables = _classifier()
    pts = _rng(11).standard_normal((8, NPOINTS, 3)).astype(np.float32)
    jfn = jax.jit(jexport.build_classifier_fn(jmodel, variables, NPOINTS))
    jref = np.asarray(jfn(jnp.asarray(pts)))
    with jq.quantized_dense():
        jint8 = np.asarray(jax.jit(jexport.build_classifier_fn(jmodel, variables, NPOINTS))(
            jnp.asarray(pts)))
    model = _port_classifier()
    with torch.no_grad():
        ref = model(torch.from_numpy(pts)).numpy()
        with q.quantized_dense():
            int8 = model(torch.from_numpy(pts)).numpy()
    scale = np.abs(jref).max()
    np.testing.assert_allclose(ref, jref, atol=1e-4 * scale)
    gap = np.abs(int8 - jint8).max() / scale
    assert gap <= QLOGIT_TOL, gap
    assert (int8.argmax(-1) == jint8.argmax(-1)).all()
    assert 0 < np.abs(int8 - ref).max() / scale < 0.15
    assert np.abs(jint8 - jref).max() / scale < 0.15


def test_only_dense_products_are_quantized():
    """LayerNorm, softmax and the rest stay float: a zero-weight dense layer
    before a LayerNorm gives exactly the float result (as
    ``tests/test_quantize.py::test_non_dense_modules_untouched``). The fused
    attention route reads its weights itself and stays fp32 under
    ``quantized_dense()``, as the JAX package's fused route escapes its
    interceptor; the unfused route is quantized."""
    torch.manual_seed(0)
    dense, norm = Dense(8, 8), LayerNorm(8)
    torch.nn.init.zeros_(dense.weight)
    x = torch.randn(4, 8)
    with torch.no_grad():
        ref = norm(dense(x) + 1.0)
        with q.quantized_dense():
            got = norm(dense(x) + 1.0)
    assert torch.equal(ref, got)
    attn = Attention(16, 2).eval()
    tokens = torch.randn(2, 8, 16)
    with torch.no_grad(), fused_attention_scope():
        fused = attn(tokens)
        with q.quantized_dense():
            assert torch.equal(attn(tokens), fused)
    with torch.no_grad():
        plain = attn(tokens)
        with q.quantized_dense():
            assert not torch.equal(attn(tokens), plain)


def test_the_int8_state_dict_picks_layers_by_type_and_loads_strictly():
    """``quantize_state_dict`` quantizes each ``Dense`` and ``PointConv`` weight
    (3-D for a ``PointConv``) and leaves the 3-D mask tokens, the norms and
    the BatchNorm statistics float; a converted module takes it with
    ``strict=True`` and, outside ``quantized_dense()``, refuses to run."""
    student = GM3DStudent(decoder_depth=1, decoder_num_heads=2, **SMALL)
    state = q.quantize_state_dict(student)
    layers = {name for name, m in student.named_modules() if isinstance(m, q.QUANT_LAYERS)}
    int8 = {k[:-len(".weight")] for k, v in state.items() if v.dtype == torch.int8}
    assert int8 == layers and len(layers) > 20
    assert state["increase_dim_2.0.weight"].shape == (1024, 48, 1)
    assert all(f"{name}.weight_scale" in state for name in layers)
    assert state["mask_token"].dtype == torch.float32 and state["mask_token"].ndim == 3
    fresh = q.quantize_module(GM3DStudent(decoder_depth=1, decoder_num_heads=2, **SMALL))
    fresh.load_state_dict(state, strict=True)
    assert sorted(fresh.state_dict()) == sorted(state)
    pts = torch.randn(2, 64, 3)
    with pytest.raises(RuntimeError, match="quantized_dense"):
        fresh.encode_features(pts)
    with torch.no_grad(), q.quantized_dense():
        assert torch.isfinite(fresh.eval().encode_features(pts)).all()


def _config(tmp_path, name, model):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump({"model": model, "npoints": NPOINTS}))
    return str(path)


SEG_MODEL = dict(NAME="PointTransformerSeg", trans_dim=32, depth=2, num_heads=2, cls_dim=50,
                 group_size=8, num_group=16, encoder_dims=32, drop_path_rate=0.0,
                 feature_blocks=[0, 1])
MAE_MODEL = {"NAME": "Point_MAE", "group_size": 8, "num_group": 16,
             "transformer_config": dict(trans_dim=48, encoder_dims=48, depth=2, num_heads=2,
                                        drop_path_rate=0.0, decoder_depth=1,
                                        decoder_num_heads=2)}


@pytest.mark.parametrize("mode", ["classifier", "features", "segmentation"])
def test_an_int8_export_is_smaller_loads_strictly_and_serves(mode, tmp_path):
    """``--quantize int8`` through the export CLI in each mode: the manifest
    says ``int8``, the artifact is smaller than the fp32 one, it loads (strict)
    and ``ServingModel`` serves outputs equal to the fp32 model's quantized
    forward (to 1e-5 of its range: the served batches are chunks of 2) and
    within 0.15 of the fp32 artifact's range."""
    model_cfg = {"classifier": dict(NAME="PointTransformer", cls_dim=15, drop_path_rate=0.0,
                                    **SMALL),
                 "features": MAE_MODEL, "segmentation": SEG_MODEL}[mode]
    cfg = _config(tmp_path, mode, model_cfg)
    flags = ["--config", cfg, "--mode", mode, "--device", "cpu", "--export_batch", "2",
             "--seed", "4"]
    if mode == "features":
        flags += ["--model_family", "pointmae"]
    fp = export_model.main(flags + ["--out", str(tmp_path / "fp.gm3dx")])
    art = export_model.main(flags + ["--quantize", "int8", "--out", str(tmp_path / "q.gm3dx")])
    assert (tmp_path / "q.gm3dx").stat().st_size < 0.6 * (tmp_path / "fp.gm3dx").stat().st_size
    _, manifest = load_artifact(art, device="cpu")
    assert manifest["quantization"] == "int8"
    served, served_fp = ServingModel(art, device="cpu"), ServingModel(fp, device="cpu")
    pts = _rng(5).standard_normal((3, NPOINTS, 3)).astype(np.float32)
    extra = (np.array([0, 4, 15], np.int32),) if mode == "segmentation" else ()
    got, ref = served.predict(pts, *extra), served_fp.predict(pts, *extra)
    # the fp32 model (its weights from the export's seed), each product quantized on the fly
    model = build_model_from_cfg(manifest["model_cfg"])
    model.reset_parameters(torch.Generator().manual_seed(4))
    model.eval()
    fn = (build_seg_fn(model) if mode == "segmentation" else
          (build_classifier_fn if mode == "classifier" else build_feature_fn)(model, NPOINTS))
    with torch.no_grad(), q.quantized_dense():
        want = fn(*(torch.from_numpy(a) for a in (pts, *extra))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert 0 < np.abs(got - ref).max() <= 0.15 * np.abs(ref).max()


def _quantized_ema_steps():
    """One GM3D step with ``quantize_ema=True`` in both packages from the same
    weights, clouds and draws: the JAX step on its CPU route
    (``use_fused_embed=False``), the port's with the patch embed and the
    attention unfused, so that every dense layer of the EMA pass is int8 on
    both sides. Also the mask each side's EMA pass picks."""
    import test_torch_port_pretrain_step as ps
    from gm3d_tpu.data.transforms import scale_and_translate as jscale
    from gm3d_tpu.masking import geometric_mask as jgeometric_mask
    from gm3d_tpu.models import GM3DStudent as JGM3DStudent
    from gm3d_tpu.models import PointMAE as JPointMAE
    from gm3d_tpu.ops.group import group_points as jgroup
    from gm3d_tpu.train.optim import build_gm3d_shared_optimizer as jbuild_optimizer
    from gm3d_tpu.train.pretrain import make_gm3d_train_step as jmake_step
    from gm3d_tpu.train.state import create_train_state as jcreate_state
    from gm3d_tpu_torch.ckpt.torch_import import load_pretrain_models
    from gm3d_tpu_torch.train import pretrain as tp
    from gm3d_tpu_torch.train.optim import build_gm3d_shared_optimizer
    from gm3d_tpu_torch.train.state import create_train_state

    jstudent, jteacher = JGM3DStudent(mode="feature", **ps.SMALL), JPointMAE(**ps.SMALL)
    svars, tvars = ps._variables(jstudent, 0), ps._variables(jteacher, 1)
    tx = jbuild_optimizer(svars["params"], ps.LR)
    jstate = jcreate_state(jax.tree.map(jnp.asarray, svars), tx, with_ema=True)
    jstep = jmake_step(jstudent, jteacher, tx, mask_ratio=0.6, use_fused_embed=False,
                       quantize_ema=True)
    student, teacher = GM3DStudent(mode="feature", **ps.SMALL), PointMAE(**ps.SMALL)
    optimizer = build_gm3d_shared_optimizer(student, ps.LR)
    state = create_train_state(student, optimizer, with_ema=True)
    load_pretrain_models(student, state.ema, teacher, svars, svars, tvars)
    step = tp.make_gm3d_train_step(student, teacher, optimizer, mask_ratio=0.6,
                                   use_fused_embed=False, use_fused_attention=False,
                                   quantize_ema=True, device="cpu")
    pts, key = ps._clouds(10), jax.random.key(0)
    scalars = {k: jnp.asarray(v, jnp.float32) for k, v in ps.SCALARS.items()}
    # the JAX step's own mask: its first half, replayed (r_aug, r_mask = split(key, 4)[:2])
    r_aug, r_mask, _, _ = jax.random.split(key, 4)
    samples = jscale(r_aug, jnp.asarray(pts))

    @jax.jit
    def ema_loss_pred(variables, samples):
        grouped = jgroup(samples, jstudent.num_group, jstudent.group_size)
        return jstudent.apply(variables, samples, jnp.zeros((ps.B, 16), bool), 0, False,
                              deterministic=True, grouped=grouped,
                              loss_pred_only=True)["loss_pred"]

    with jq.quantized_dense():  # the interceptor acts while the function is traced
        loss_pred = ema_loss_pred(jstate.ema_variables(), samples)
    jmask = np.asarray(jgeometric_mask(r_mask, loss_pred, ps.NUM_MASK, scalars["keep_ratio"]))
    # the port's EMA pass on the same samples, int8 and fp32
    from gm3d_tpu_torch.data.transforms import scale_and_translate
    from gm3d_tpu_torch.ops.group import group_points

    draws = ps._draws(key)
    tsamples = scale_and_translate(None, torch.from_numpy(pts), scale=draws["scale"],
                                   shift=draws["shift"])
    zeros = torch.zeros((ps.B, 16), dtype=torch.bool)
    with torch.no_grad():
        grouped = group_points(tsamples, student.num_group, student.group_size)
        ema_fp = state.ema(tsamples, zeros, 0, grouped=grouped, loss_pred_only=True)
        with q.quantized_dense():
            ema_int8 = state.ema(tsamples, zeros, 0, grouped=grouped, loss_pred_only=True)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, tvars), jnp.asarray(pts), key, scalars)
    state, m = step(state, torch.from_numpy(pts), None, ps.SCALARS, draws=draws)
    return ({k: float(jm[k]) for k in ps.KEYS}, {k: float(m[k]) for k in ps.KEYS}, jmask,
            step.last_mask.numpy(), np.asarray(loss_pred), ema_int8["loss_pred"].numpy(),
            ema_fp["loss_pred"].numpy())


def test_the_quantize_ema_step_equals_the_jax_step(monkeypatch):
    """The step runs its EMA pass through the int8 layers (counted), whose
    predicted losses are the JAX package's int8 ones and not the fp32 ones.
    Both steps pick the same mask first; then the step's metrics agree to the
    step test's ``rtol=2e-4``."""
    import test_torch_port_pretrain_step as ps

    calls = []
    int8_layer = q._int8_layer
    monkeypatch.setattr(q, "_int8_layer", lambda *a: calls.append(1) or int8_layer(*a))
    want, got, jmask, mask, jpred, pred, pred_fp = _quantized_ema_steps()
    # the replay and the step's EMA pass: the same dense layers each
    assert len(calls) > 0 and len(calls) % 2 == 0, len(calls)
    # most groups' predicted losses equal the JAX int8 ones to rounding (median
    # gap measured 1.8e-7 of the range), far from the fp32 ones (1.4e-2); a
    # rounding flip in one cloud's early layer moves that cloud's groups by up
    # to 3.8e-2 of the range, within the int8 noise itself (4.9e-2 from fp32)
    scale = np.abs(jpred).max()
    assert np.median(np.abs(pred - jpred)) <= 1e-5 * scale
    assert np.median(np.abs(pred_fp - jpred)) > 1e-3 * scale
    assert np.abs(pred - jpred).max() <= np.abs(pred_fp - pred).max()
    np.testing.assert_array_equal(mask, jmask)
    for key in ps.KEYS:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=1e-7, err_msg=key)

"""The port's self-contained serving artifact against the JAX package's (CPU).

``gm3d_tpu_torch/serve/export.py`` (a ``torch.export`` program in the
``.gm3dx``, FPS / KNN / the int8 product as the custom ops ``gm3d::fps``,
``gm3d::knn``, ``gm3d::int8_mm``) against ``gm3d_tpu/serve/export.py``
(``export_forward`` / ``save_artifact`` / ``load_artifact``). The same numpy
variables, seeded, go into both packages' models; both artifacts are
exported, saved, loaded and run on the same clouds. Also: ``opcheck`` of the
three ops, the ops in the program's graph (counts per served path, none of
the plain versions' unrolled loops), ``--platforms``, the refusals, a load
that needs no model code, and ``tools/orbax_to_torch.py --kind`` carrying a
JAX classifier and a JAX Point-M2AE classifier into served artifacts.

Small sizes: depth 2, width 48, 16 groups x 8 points, 128 points a cloud
(Point-M2AE: 32 / 16 / 8 groups, widths 24 / 48 / 96).

Tolerances: fp32 outputs ``atol=1e-4`` (as ``test_torch_port_serve.py``: the
grouping indices are equal, only summation order differs); int8 logits
within ``QLOGIT_TOL`` of the JAX logits' range (``test_torch_port_quantize.py``);
bf16 logits within ``BF16_TOL`` of the range (a bf16 ulp is 2^-8 relative, and
the two frameworks round at other places through patch embed, two blocks and
the head).
"""

import functools
import importlib.util
import io
import json
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_threads import torch_at_one_thread  # noqa: F401
from gm3d_tpu.ckpt import save_checkpoint as jsave_checkpoint
from gm3d_tpu.models import PointM2AEClassifier as JM2AEClassifier
from gm3d_tpu.models import PointMAE as JPointMAE
from gm3d_tpu.models import PointTransformer as JPointTransformer
from gm3d_tpu.models.segmentation import PointMAESeg as JPointMAESeg
from gm3d_tpu.serve import export as jexport
from gm3d_tpu.serve import quantize as jq
from gm3d_tpu_torch.ckpt.torch_import import (
    M2AE_CLASSIFIER_MAP,
    POINT_MAE_MAP,
    POINT_MAE_SEG_MAP,
    POINT_TRANSFORMER_MAP,
    load_flax_variables,
)
from gm3d_tpu_torch.cli import export_model
from gm3d_tpu_torch.models import PointM2AEClassifier, PointMAE, PointMAESeg, PointTransformer
from gm3d_tpu_torch.serve import (ServingModel, build_classifier_fn, build_feature_fn,
                                  build_seg_fn, export_forward, load_artifact, save_artifact)
from gm3d_tpu_torch.serve.quantize import quantize_module

REPO = Path(__file__).resolve().parents[1]
NPOINTS, BATCH, CLS = 128, 4, 7
SMALL = dict(trans_dim=48, depth=2, num_heads=2, group_size=8, num_group=16, encoder_dims=48)
DEC = dict(decoder_depth=1, decoder_num_heads=2)
SEG = dict(SMALL, drop_path_rate=0.0, feature_blocks=(0, 1))
M2AE = dict(num_groups=(32, 16, 8), group_sizes=(8, 4, 4), encoder_depths=(1, 1, 1),
            encoder_dims=(24, 48, 96), local_radius=(0.32, 0.64, 1.28), num_heads=2)
QLOGIT_TOL, BF16_TOL = 2e-2, 3e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(jmodel, *init_args, seed=0):
    """Seeded numpy variables in the tree ``jmodel.init`` would give: weights
    of the init's scale, biases, norm scales and running statistics away from
    their init."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "var":
            return 1.0 + 0.5 * np.abs(noise)
        if name == "kernel":
            return noise / np.sqrt(s.shape[0])
        return (1.0 if name == "scale" else 0.0) + 0.1 * noise

    shapes = jax.eval_shape(lambda key: jmodel.init(key, *init_args), jax.random.key(0))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _clouds(seed, b=BATCH, n=NPOINTS):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


def _categories(seed, b=BATCH):
    return np.random.default_rng(seed).integers(0, 16, b).astype(np.int32)


def _zeros(n=NPOINTS):
    return jnp.zeros((2, n, 3))


# ---------------------------------------------------------------------------
# the three custom ops


@pytest.mark.parametrize("args", [((2, 64, 3), 8), ((1, 20, 3), 20), ((3, 9, 3), 1)],
                         ids=["64_to_8", "all_points", "one"])
def test_opcheck_fps(args):
    shape, n = args
    xyz = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    torch.library.opcheck(torch.ops.gm3d.fps.default, (xyz, n))


@pytest.mark.parametrize("args", [(64, 9, 4, False), (12, 30, 12, False), (64, 9, 4, True)],
                         ids=["k4", "k_eq_n", "ref_requires_grad"])
def test_opcheck_knn(args):
    n, g, k, grad = args
    rng = np.random.default_rng(2)
    ref = torch.from_numpy(rng.standard_normal((2, n, 3)).astype(np.float32)).requires_grad_(grad)
    query = torch.from_numpy(rng.standard_normal((2, g, 3)).astype(np.float32))
    torch.library.opcheck(torch.ops.gm3d.knn.default, (ref, query, k))
    dist, idx = torch.ops.gm3d.knn(ref, query, k)
    assert not dist.requires_grad and dist.dtype == torch.float32 and idx.dtype == torch.int32


@pytest.mark.parametrize("shape", [(37, 48, 144), (4, 3, 15), (1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_opcheck_int8_mm(shape):
    m, k, n = shape
    rng = np.random.default_rng(3)
    qx = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    torch.library.opcheck(torch.ops.gm3d.int8_mm.default, (qx, qw))
    got = torch.ops.gm3d.int8_mm(qx, qw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), (qx.long() @ qw.long().t()).numpy())


def test_every_op_has_a_cuda_kernel_and_a_cpu_one():
    for name in ("gm3d::fps", "gm3d::knn", "gm3d::int8_mm"):
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (name, key)


# ---------------------------------------------------------------------------
# the two packages' artifacts of one model


@functools.lru_cache(maxsize=None)
def _jax_models():
    classifier = JPointTransformer(cls_dim=CLS, **SMALL)
    mae = JPointMAE(**SMALL, **DEC)
    seg = JPointMAESeg(**SEG)
    mask = jnp.zeros((2, 16), bool).at[:, :9].set(True)
    return {
        "classifier": (classifier, _variables(classifier, _zeros(), seed=0)),
        "features": (mae, _variables(mae, _zeros(), mask, 9, seed=4)),
        "segmentation": (seg, _variables(seg, _zeros(), jnp.zeros((2,), jnp.int32), seed=6)),
    }


def _port_model(mode, variables, dtype=torch.float32):
    if mode == "classifier":
        model = PointTransformer(cls_dim=CLS, **SMALL, dtype=dtype)
        return load_flax_variables(model, variables, POINT_TRANSFORMER_MAP)
    if mode == "features":
        return load_flax_variables(PointMAE(**SMALL, **DEC, dtype=dtype), variables,
                                   POINT_MAE_MAP)
    return load_flax_variables(PointMAESeg(**SEG, dtype=dtype), variables, POINT_MAE_SEG_MAP)


# case -> (mode, input points, quantize, bf16)
CASES = {
    "classifier": ("classifier", NPOINTS, None, False),
    "classifier_fps_in_graph": ("classifier", 2 * NPOINTS, None, False),
    "features": ("features", NPOINTS, None, False),
    "features_fps_in_graph": ("features", 2 * NPOINTS, None, False),
    "segmentation": ("segmentation", NPOINTS, None, False),
    "classifier_int8": ("classifier", NPOINTS, "int8", False),
    "classifier_bf16": ("classifier", NPOINTS, None, True),
}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """case -> (the port's artifact, the JAX package's), each exported once."""
    tmp = tmp_path_factory.mktemp("artifacts")
    made = {}

    def get(case):
        if case in made:
            return made[case]
        mode, n_input, quantize, bf16 = CASES[case]
        jmodel, variables = _jax_models()[mode]
        model = _port_model(mode, variables)
        if bf16:
            jmodel = jmodel.clone(dtype=jnp.bfloat16)
            model = _port_model(mode, variables, torch.bfloat16)
        if quantize:
            variables, model = jq.quantize_variables(variables), quantize_module(model)
        model.eval()
        manifest = {"mode": mode, "model": type(model).__name__, "npoints": NPOINTS,
                    "ckpt_step": -1, "compute_dtype": "bfloat16" if bf16 else "float32",
                    "quantization": quantize or "none"}
        points = torch.zeros(BATCH, n_input, 3)
        jpoints = jnp.zeros((BATCH, n_input, 3), jnp.float32)
        if mode == "segmentation":
            fn, jfn = build_seg_fn(model), jexport.build_seg_fn(jmodel, variables)
            example = (points, torch.zeros(BATCH, dtype=torch.int32))
            jexample = (jpoints, jnp.zeros((BATCH,), jnp.int32))
            manifest.update(seg_classes={"Airplane": [0, 1, 2, 3]}, cls_names=["Airplane"])
        elif mode == "classifier":
            fn = build_classifier_fn(model, NPOINTS)
            jfn = jexport.build_classifier_fn(jmodel, variables, NPOINTS)
            example, jexample = points, jpoints
        else:
            fn = build_feature_fn(model, NPOINTS)
            jfn = jexport.build_feature_fn(jmodel, variables, NPOINTS)
            example, jexample = points, jpoints
        art = save_artifact(str(tmp / f"{case}.gm3dx"),
                            export_forward(fn, example, quantize=quantize), manifest)
        jart = jexport.save_artifact(str(tmp / f"{case}_jax.gm3dx"),
                                     jexport.export_forward(jfn, jexample, quantize=quantize),
                                     manifest)
        made[case] = art, jart
        return made[case]

    return get


def _inputs(case):
    mode, n_input, _, _ = CASES[case]
    pts = _clouds(11, n=n_input)
    return (pts, _categories(12)) if mode == "segmentation" else (pts,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loaded_artifact_equals_the_jax_packages(artifacts, case):
    art, jart = artifacts(case)
    fn, manifest = load_artifact(art, device="cpu")
    jfn, jmanifest = jexport.load_artifact(jart)
    inputs = _inputs(case)
    got, want = fn(*inputs), np.asarray(jfn(*inputs), np.float32)
    assert got.shape == want.shape == tuple(manifest["output_shape"])
    assert manifest["output_shape"] == jmanifest["output_shape"]
    assert manifest["input_shape"] == jmanifest["input_shape"]
    assert manifest.get("extra_inputs") == jmanifest.get("extra_inputs")
    assert manifest["platforms"] == ["cpu"] and manifest["format_version"] == 2
    # device_call (the program's graph called directly) against torch's module
    tensors = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        assert torch.equal(fn.device_call(*tensors), fn.program.module()(*tensors))
    with pytest.raises(ValueError, match="takes points of shape"):
        fn.device_call(tensors[0][:1], *tensors[1:])
    if case.endswith("int8"):
        gap = np.abs(got - want).max() / np.abs(want).max()
        assert gap <= QLOGIT_TOL, gap
    elif case.endswith("bf16"):
        gap = np.abs(got - want).max() / np.abs(want).max()
        assert gap <= BF16_TOL, gap
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _ops(program):
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def _plain_nodes(program):
    """Nodes traced out of the plain versions' Python loops or sorts."""
    return [n for n in program.graph.nodes
            if any(f in n.meta.get("stack_trace", "") or "" for f in
                   ("fps_indices_torch", "knn_indices_torch", "_int8_mm_op"))]


# case -> (FPS nodes, KNN nodes, int8 products): PERF.md's launches of a served
# batch; int8, every dense layer of the classifier (4 patch-embed convolutions, 2
# positional layers, 4 a block, 3 in the head)
GRAPH = {"classifier": (1, 1, 0), "classifier_fps_in_graph": (2, 1, 0),
         "features": (1, 1, 0), "features_fps_in_graph": (2, 1, 0),
         "segmentation": (1, 2, 0), "classifier_int8": (1, 1, 4 + 2 + 4 * 2 + 3)}


@pytest.mark.parametrize("case", sorted(GRAPH))
def test_the_program_holds_the_ops_and_no_plain_loop(artifacts, case):
    fn, _ = load_artifact(artifacts(case)[0], device="cpu")
    ops = _ops(fn.program)
    fps_n, knn_n, int8_n = GRAPH[case]
    assert ops.count("gm3d.fps.default") == fps_n
    assert ops.count("gm3d.knn.default") == knn_n
    assert ops.count("gm3d.int8_mm.default") == int8_n
    assert not _plain_nodes(fn.program)
    # the plain FPS's loop alone traced 3,680 nodes for this classifier at 256 points
    assert len(fn.program.graph.nodes) < 1000
    # the trace's dtype assertions and eval-mode dropout are taken out
    assert "aten._assert_tensor_metadata.default" not in ops
    assert "aten.dropout.default" not in ops


def test_the_m2ae_classifier_program_holds_its_hierarchy():
    """Three FPS and three KNN at the input's point count (the hierarchy), one
    more FPS above it (down to npoints)."""
    for n_input, fps_n in ((NPOINTS, 3), (2 * NPOINTS, 4)):
        model = PointM2AEClassifier(cls_dim=10, **M2AE).eval()
        program = export_forward(build_classifier_fn(model, NPOINTS),
                                 torch.zeros(2, n_input, 3)).program
        ops = _ops(program)
        assert (ops.count("gm3d.fps.default"), ops.count("gm3d.knn.default")) == (fps_n, 3)
        assert not _plain_nodes(program)


def test_the_program_moves_with_every_constant(artifacts):
    """Moved to the meta device, the program runs on a meta input: no weight,
    constant or tensor it makes stays behind on the CPU."""
    from torch.export.passes import move_to_device_pass

    for case in ("segmentation", "classifier_int8"):
        fn, manifest = load_artifact(artifacts(case)[0], device="cpu")
        program = move_to_device_pass(fn.program, "meta")
        inputs = [torch.zeros(manifest["input_shape"], device="meta")]
        inputs += [torch.zeros(s["shape"], dtype=getattr(torch, s["dtype"]), device="meta")
                   for s in manifest.get("extra_inputs", [])]
        out = program.module()(*inputs)
        assert out.device.type == "meta" and list(out.shape) == manifest["output_shape"]
        assert {str(n.kwargs["device"]) for n in program.graph.nodes
                if "device" in n.kwargs} <= {"meta"}


def test_loading_needs_no_model_code(artifacts, tmp_path):
    """In a process of its own: ``load_artifact`` serves the artifact, and
    ``torch.export.load`` of its program runs after importing the ops alone;
    neither imports the port's models or config."""
    art = artifacts("classifier")[0]
    with zipfile.ZipFile(art) as zf:
        (tmp_path / "program.pt2").write_bytes(zf.read("program.pt2"))
    np.save(tmp_path / "x.npy", _inputs("classifier")[0])
    script = f"""
import sys, numpy as np, torch
import gm3d_tpu_torch.ops
x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))
with torch.no_grad():
    bare = torch.export.load({str(tmp_path / 'program.pt2')!r}).module()(x)
from gm3d_tpu_torch.serve.export import load_artifact
fn, _ = load_artifact({art!r}, device="cpu")
assert np.array_equal(fn(x.numpy()), bare.numpy())
loaded = [m for m in sys.modules if m.startswith(("gm3d_tpu_torch.models",
                                                  "gm3d_tpu_torch.config", "gm3d_tpu."))]
assert not loaded, loaded
print(bare.shape)
"""
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith(f"torch.Size([{BATCH}, {CLS}])")


# ---------------------------------------------------------------------------
# --platforms and the refusals


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    """The export CLI with ``--platforms cpu,cuda``, traced on the CPU."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = tmp / "cls.yaml"
    cfg.write_text(yaml.safe_dump({"model": {"NAME": "PointTransformer", "cls_dim": CLS,
                                             "drop_path_rate": 0.1, **SMALL},
                                   "npoints": NPOINTS}))
    flags = ["--config", str(cfg), "--device", "cpu", "--export_batch", str(BATCH)]
    both = export_model.main(flags + ["--platforms", "cpu,cuda", "--out", str(tmp / "b.gm3dx")])
    cuda = export_model.main(flags + ["--platforms", "cuda", "--out", str(tmp / "c.gm3dx")])
    return flags, both, cuda, tmp


def test_platforms_cpu_cuda_is_accepted_and_served_on_the_cpu(cli_artifact):
    _, both, _, _ = cli_artifact
    serving = ServingModel(both, device="cpu")
    assert serving.manifest["platforms"] == ["cpu", "cuda"]
    assert serving.info["platforms"] == ["cpu", "cuda"]
    out = serving.predict(_clouds(13, 6))
    assert out.shape == (6, CLS) and np.isfinite(out).all()


def test_a_cuda_only_artifact_is_refused_on_the_cpu(cli_artifact):
    flags, _, cuda, tmp = cli_artifact
    assert json.loads(zipfile.ZipFile(cuda).read("manifest.json"))["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="re-export with --platforms cpu"):
        load_artifact(cuda, device="cpu")
    with pytest.raises(ValueError, match="re-export with --platforms cpu"):
        ServingModel(cuda, device="cpu")
    for bad in ("tpu", "cpu,gpu", ""):
        with pytest.raises(ValueError, match="platforms"):
            export_model.main(flags + ["--platforms", bad, "--out", str(tmp / "x.gm3dx")])


def test_a_format_1_artifact_is_refused(cli_artifact, tmp_path):
    """The earlier format (a state dict, ``weights.pt``, rebuilt from model
    code) is refused with the advice to export again."""
    _, both, _, _ = cli_artifact
    manifest = json.loads(zipfile.ZipFile(both).read("manifest.json"))
    old = tmp_path / "old.gm3dx"
    blob = io.BytesIO()
    torch.save({"w": torch.zeros(2)}, blob)
    with zipfile.ZipFile(old, "w") as zf:
        zf.writestr("manifest.json", json.dumps(dict(manifest, format_version=1)))
        zf.writestr("weights.pt", blob.getvalue())
    with pytest.raises(ValueError, match="format 1 .*re-export"):
        load_artifact(str(old), device="cpu")


# ---------------------------------------------------------------------------
# tools/orbax_to_torch.py --kind: a JAX checkpoint into a served artifact


def _converter():
    spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                                  REPO / "tools" / "orbax_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind", ["classifier", "m2ae_classifier"])
def test_a_jax_checkpoint_is_carried_into_a_served_artifact(kind, tmp_path):
    """The JAX package's saver writes an orbax checkpoint of a classifier's
    seeded variables; the tool converts it with ``--kind``; the export CLI
    exports the port's checkpoint; ``ServingModel`` serves the JAX
    ``build_classifier_fn``'s logits."""
    if kind == "classifier":
        jmodel = JPointTransformer(cls_dim=CLS, **SMALL)
        model_cfg = {"NAME": "PointTransformer", "cls_dim": CLS, "drop_path_rate": 0.1,
                     **SMALL}
    else:
        jmodel = JM2AEClassifier(cls_dim=10, **M2AE)
        model_cfg = {"NAME": "Point_M2AE_ModelNet40", "cls_dim": 10, "drop_path_rate": 0.1,
                     **{k: list(v) if isinstance(v, tuple) else v for k, v in M2AE.items()}}
    variables = _variables(jmodel, _zeros(), seed=8)
    jsave_checkpoint(str(tmp_path / "orbax"),
                     {"params": variables["params"], "batch_stats": variables["batch_stats"],
                      "step": jnp.asarray(5)}, 5)
    assert _converter().main([str(tmp_path / "orbax"), str(tmp_path / "port"),
                              "--kind", kind]) == 5
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({"model": model_cfg, "npoints": NPOINTS}))
    art = export_model.main(["--config", str(cfg), "--ckpt", str(tmp_path / "port"),
                             "--device", "cpu", "--export_batch", str(BATCH),
                             "--out", str(tmp_path / "m.gm3dx")])
    serving = ServingModel(art, device="cpu")
    assert serving.manifest["ckpt_step"] == 5
    pts = _clouds(14, BATCH + 1)
    want = np.asarray(jax.jit(jexport.build_classifier_fn(jmodel, variables, NPOINTS))(
        jnp.asarray(pts)))
    np.testing.assert_allclose(serving.predict(pts), want, atol=1e-4, rtol=0)

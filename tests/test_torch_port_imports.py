"""gm3d_tpu_torch stands on torch alone and starts without a GPU toolchain.

Importing every module of the port in a fresh interpreter must pull in
neither ``jax`` nor ``flax`` nor any module of ``gm3d_tpu``, nor ``sklearn``
(the card's machine has none: the SVM probe fits its own SVC), and must work on
a machine with no GPU and no ``nvcc`` (the kernels are built at first
launch, not at import). Entry points default to the GPU and must say so
instead of continuing on the CPU.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "gm3d_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import gm3d_tpu_torch
names = ["gm3d_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    gm3d_tpu_torch.__path__, "gm3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax", "gm3d_tpu",
                                    "sklearn"))
print("IMPORTED", len(names))
print("NAMES", " ".join(names))
print("FOREIGN", bad)
"""

# the modules of the pretrain CLI's slice: datasets, loader, prefetch, meters,
# logging, the metrics pipeline, the NaN exit and the CLI itself
PRETRAIN_CLI_MODULES = {
    "gm3d_tpu_torch.data.io", "gm3d_tpu_torch.data.datasets", "gm3d_tpu_torch.data.prefetch",
    "gm3d_tpu_torch.data.transforms", "gm3d_tpu_torch.utils.meters",
    "gm3d_tpu_torch.utils.logging", "gm3d_tpu_torch.utils.pipeline",
    "gm3d_tpu_torch.utils.debug", "gm3d_tpu_torch.cli.common", "gm3d_tpu_torch.cli.pretrain",
}


# checkpoints, the asynchronous writer, preemption and tracing
CKPT_MODULES = {
    "gm3d_tpu_torch.ckpt.checkpoint", "gm3d_tpu_torch.ckpt.async_writer",
    "gm3d_tpu_torch.utils.preempt", "gm3d_tpu_torch.utils.profiling",
}


# the SVM probe and the linear SVC it fits
PROBE_MODULES = {"gm3d_tpu_torch.eval.svm", "gm3d_tpu_torch.eval.linear_svc"}


# part segmentation and the few-shot harness
SEG_FEWSHOT_MODULES = {
    "gm3d_tpu_torch.models.segmentation", "gm3d_tpu_torch.train.segmentation",
    "gm3d_tpu_torch.cli.finetune_seg", "gm3d_tpu_torch.cli.fewshot",
    "gm3d_tpu_torch.data.fewshot_gen", "gm3d_tpu_torch.eval.metrics",
}


# the Point-M2AE family: its model; its steps, CLI, probe pooling, layer decay,
# name tables, transfer and export live in modules listed above or earlier
M2AE_MODULES = {"gm3d_tpu_torch.models.m2ae", "gm3d_tpu_torch.train.pretrain",
                "gm3d_tpu_torch.train.optim", "gm3d_tpu_torch.ckpt.torch_import",
                "gm3d_tpu_torch.ckpt.transfer", "gm3d_tpu_torch.cli.finetune",
                "gm3d_tpu_torch.cli.export_model", "gm3d_tpu_torch.config.registry"}


# offline evaluation, visualisation and int8 quantization
EVAL_QUANT_MODULES = {
    "gm3d_tpu_torch.cli.evaluate", "gm3d_tpu_torch.cli.visualize", "gm3d_tpu_torch.eval.knn",
    "gm3d_tpu_torch.eval.linear_probe", "gm3d_tpu_torch.eval.visualize",
    "gm3d_tpu_torch.utils.ply", "gm3d_tpu_torch.utils.plot_logs",
    "gm3d_tpu_torch.serve.quantize",
}


# the last two pretraining objectives: CLIP distillation and the EMD loss
CLIP_EMD_MODULES = {"gm3d_tpu_torch.models.clip", "gm3d_tpu_torch.ops.emd"}


# data parallelism over several GPUs and the C++ loader: the last modules
PARALLEL_NATIVE_MODULES = {
    "gm3d_tpu_torch.parallel", "gm3d_tpu_torch.parallel.context",
    "gm3d_tpu_torch.parallel.mesh", "gm3d_tpu_torch.parallel.multihost",
    "gm3d_tpu_torch.native", "gm3d_tpu_torch.native.native_loader",
    "gm3d_tpu_torch.scripts.make_disk_datasets",
}


def _run(code, **env):
    full_env = dict(os.environ, PYTHONPATH=str(REPO), **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), env=full_env, timeout=300)


def test_every_module_imports_without_jax_or_the_jax_package():
    # an empty PATH and no CUDA_HOME: no nvcc can be found, the import must not look
    res = _run(_IMPORT_ALL, PATH="", CUDA_HOME="", CUDA_PATH="")
    assert res.returncode == 0, res.stderr
    lines = dict(ln.split(" ", 1) for ln in res.stdout.strip().splitlines())
    assert int(lines["IMPORTED"]) >= 91
    assert (PRETRAIN_CLI_MODULES | CKPT_MODULES | PROBE_MODULES | SEG_FEWSHOT_MODULES
            | M2AE_MODULES | EVAL_QUANT_MODULES | CLIP_EMD_MODULES | PARALLEL_NATIVE_MODULES
            <= set(lines["NAMES"].split()))
    assert lines["FOREIGN"] == "[]"


def test_every_module_of_the_jax_package_has_its_counterpart():
    """Each of the JAX package's 64 modules (``__init__.py`` aside) has the
    port's module at the same path."""
    def modules(root):
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
                if p.name != "__init__.py"}

    jax_side = modules(REPO / "gm3d_tpu")
    assert len(jax_side) == 64
    assert not sorted(jax_side - modules(PKG))
    # the C++ loader's source ships with the port, outside csrc/ (nvcc's)
    assert 'extern "C" {' in (PKG / "native" / "loader.cpp").read_text()
    assert not list((PKG / "native").glob("*.so"))


def test_sources_name_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"import jax|from jax|import flax|from flax|import orbax|"
                         r"from orbax|import optax|from optax|import sklearn|from sklearn|"
                         r"gm3d_tpu(\.| import)")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    hits = []
    for path in files:
        for no, line in enumerate(path.read_text().splitlines(), 1):
            # docstrings may cite the counterpart as a path (``gm3d_tpu/ops/fps.py``)
            if pattern.search(line) and not line.lstrip().startswith("#"):
                hits.append(f"{path.relative_to(REPO)}:{no}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_the_converter_stays_outside_the_port():
    """``tools/orbax_to_torch.py`` needs JAX and orbax; nothing of the port
    imports it, and it is not inside the package."""
    converter = REPO / "tools" / "orbax_to_torch.py"
    assert "from gm3d_tpu.ckpt import restore_raw" in converter.read_text()
    assert not (PKG / "tools").exists()
    pattern = re.compile(r"^\s*(import|from)\s+(tools|orbax_to_torch)\b", re.M)
    for path in sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_kernel_sources_ship_with_the_package():
    names = ["fps.cu", "fused_attention.cu", "knn.cu", "patch_embed.cu", "tile_mma_test.cu"]
    for name in names:
        text = (PKG / "csrc" / name).read_text()
        assert 'extern "C"' in text and "torch/extension.h" not in text
        # a kernel is written here, not called: no library behind the C interface
        assert not re.search(r"cublas|cudnn|cutlass/gemm/device", text, re.I), name
    # the attention and patch-embed kernels multiply on the tensor cores, in the
    # repo's own source, and through nothing else
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in (
        PKG / "csrc" / "tile_mma.cuh").read_text()
    for name in ("fused_attention.cu", "patch_embed.cu"):
        text = (PKG / "csrc" / name).read_text()
        assert "tile_mma<" in text and "tile_gemm" not in text, name
    assert "tile_gemm(" not in (PKG / "csrc" / "tile_gemm.cuh").read_text()
    for entry in ("gm3d_attn_fwd", "gm3d_attn_bwd"):
        assert entry in (PKG / "csrc" / "fused_attention.cu").read_text()
    assert "gm3d_patch_embed" in (PKG / "csrc" / "patch_embed.cu").read_text()
    from gm3d_tpu_torch.ops import _build

    assert [p.name for p in _build.sources()] == names
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library_path().parent == PKG / "build"
    assert _build.library_path() == _build.library_path()  # a pure content hash


def test_building_without_nvcc_raises(monkeypatch):
    from gm3d_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    import yaml

    from gm3d_tpu_torch.cli import export_model

    tmp = tmp_path_factory.mktemp("imports")
    cfg = tmp / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"npoints": 32, "model": dict(
        NAME="PointTransformer", trans_dim=16, depth=1, num_heads=2, cls_dim=3,
        group_size=4, num_group=4, encoder_dims=16, drop_path_rate=0.0)}))
    return str(cfg), export_model.main(["--config", str(cfg), "--device", "cpu",
                                        "--out", str(tmp / "tiny.gm3dx"),
                                        "--export_batch", "2"])


def test_entry_points_default_to_cuda_and_say_so(artifact, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    from gm3d_tpu_torch.cli import export_model
    from gm3d_tpu_torch.cli import serve as serve_cli
    from gm3d_tpu_torch.serve import ServingModel, load_artifact
    from gm3d_tpu_torch.serve.server import make_server

    cfg, art = artifact
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model.main(["--config", cfg, "--out", str(tmp_path / "x.gm3dx")])
    assert not (tmp_path / "x.gm3dx").exists()
    for entry in (lambda: load_artifact(art), lambda: ServingModel(art),
                  lambda: make_server(art), lambda: serve_cli.main(["--artifact", art])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


def test_train_entry_points_default_to_cuda_and_say_so():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    from gm3d_tpu_torch.models import GM3DStudent
    from gm3d_tpu_torch.scripts import profile_pretrain
    from gm3d_tpu_torch.train.optim import build_gm3d_shared_optimizer
    from gm3d_tpu_torch.train.pretrain import make_gm3d_train_step

    tiny = dict(trans_dim=16, depth=1, num_heads=2, group_size=4, num_group=4,
                encoder_dims=16, decoder_depth=1, decoder_num_heads=2)
    student = GM3DStudent(**tiny)
    optimizer = build_gm3d_shared_optimizer(student, 1e-3)
    for entry in (lambda: make_gm3d_train_step(student, None, optimizer),
                  lambda: profile_pretrain.build_pretrain_setup(**tiny),
                  lambda: profile_pretrain.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    # asked for, the CPU is taken
    make_gm3d_train_step(student, None, optimizer, device="cpu")
    state, teacher = profile_pretrain.build_pretrain_setup(device="cpu", **tiny)
    assert next(state.student.parameters()).device.type == "cpu" and not teacher.training
    with pytest.raises(SystemExit, match="GPU"):
        profile_pretrain.main(["--device", "cpu"])


def test_finetune_entry_points_default_to_cuda_and_say_so(tmp_path):
    """The finetune CLI and the three step constructors of ``train/finetune.py``
    raise without a GPU unless given ``--device cpu`` / ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    from gm3d_tpu_torch.cli import finetune as finetune_cli
    from gm3d_tpu_torch.models import PointTransformer
    from gm3d_tpu_torch.train import finetune
    from gm3d_tpu_torch.train.optim import build_finetune_optimizer

    model = PointTransformer(trans_dim=16, depth=1, num_heads=2, cls_dim=3, group_size=4,
                             num_group=4, encoder_dims=16)
    optimizer = build_finetune_optimizer(model.named_parameters(), 1e-3)
    flags = ["--config", "configs/pointmae/finetune_modelnet.yaml", "--synthetic",
             "--output_dir", str(tmp_path)]
    for entry in (lambda: finetune_cli.main(flags),
                  lambda: finetune.make_finetune_train_step(model, optimizer),
                  lambda: finetune.make_eval_step(model),
                  lambda: finetune.make_vote_eval_step(model)):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert not (tmp_path / "log.txt").exists()
    # asked for, the CPU is taken
    finetune.make_finetune_train_step(model, optimizer, device="cpu")
    logits = finetune.make_eval_step(model, 32, device="cpu")(torch.randn(2, 32, 3))
    assert logits.shape == (2, 3)
    vote = finetune.make_vote_eval_step(model, 1024, times=2, device="cpu")
    assert vote(torch.randn(2, 1024, 3), torch.Generator()).shape == (2, 3)


def test_seg_and_fewshot_entry_points_default_to_cuda_and_say_so(tmp_path):
    """The segmentation and few-shot CLIs and the seg steps of
    ``train/segmentation.py`` raise without a GPU unless given ``--device
    cpu`` / ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    from gm3d_tpu_torch.cli import fewshot as fewshot_cli
    from gm3d_tpu_torch.cli import finetune_seg as seg_cli
    from gm3d_tpu_torch.models import PointMAESeg
    from gm3d_tpu_torch.train import segmentation

    model = PointMAESeg(trans_dim=16, depth=2, num_heads=2, group_size=4, num_group=8,
                        encoder_dims=16, feature_blocks=(0, 1))
    optimizer = torch.optim.SGD(model.parameters(), lr=1e-3)
    seg_flags = ["--config", "configs/pointmae/seg_shapenetpart.yaml", "--synthetic",
                 "--output_dir", str(tmp_path / "seg")]
    fs_flags = ["--config", "configs/pointmae/fewshot.yaml", "--synthetic",
                "--output_dir", str(tmp_path / "fs")]
    for entry in (lambda: seg_cli.main(seg_flags), lambda: fewshot_cli.main(fs_flags),
                  lambda: segmentation.make_seg_train_step(model, optimizer),
                  lambda: segmentation.make_seg_eval_step(model)):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert not (tmp_path / "seg" / "log.txt").exists()
    assert not (tmp_path / "fs" / "log.txt").exists()
    # asked for, the CPU is taken
    segmentation.make_seg_train_step(model, optimizer, device="cpu")
    logits = segmentation.make_seg_eval_step(model, device="cpu")(torch.randn(2, 32, 3),
                                                                  torch.tensor([0, 15]))
    assert logits.shape == (2, 32, 50)


def test_m2ae_entry_points_default_to_cuda_and_say_so(tmp_path):
    """The pretrain CLI on ``--model_family m2ae`` / ``m2ae_gm3d`` and both
    M2AE steps raise without a GPU unless given ``--device cpu`` /
    ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    from gm3d_tpu_torch.cli import pretrain as pretrain_cli
    from gm3d_tpu_torch.models import PointM2AE
    from gm3d_tpu_torch.train import pretrain

    model = PointM2AE(num_groups=(16, 8, 4), group_sizes=(4, 4, 2), encoder_depths=(1, 1, 1),
                      encoder_dims=(8, 16, 24), decoder_dims=(24, 16), num_heads=2)
    optimizer = torch.optim.SGD(model.parameters(), lr=1e-3)
    for family in ("m2ae", "m2ae_gm3d"):
        with pytest.raises(RuntimeError, match="CUDA"):
            pretrain_cli.main(["--config", "configs/m2ae/config_Point_M2AE.yaml",
                               "--model_family", family, "--synthetic",
                               "--output_dir", str(tmp_path / family)])
        assert not (tmp_path / family / "log.txt").exists()
    for make in (pretrain.make_m2ae_train_step, pretrain.make_m2ae_gm3d_train_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(model, optimizer)
        make(model, optimizer, device="cpu")  # asked for, the CPU is taken


def test_evaluate_and_visualize_default_to_cuda_and_say_so(tmp_path):
    """The evaluate and visualize CLIs raise without a GPU unless given
    ``--device cpu``, before they read a checkpoint or write a file."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    from gm3d_tpu_torch.cli import evaluate, visualize

    for entry in (lambda: evaluate.main(["--config", "configs/pointmae/finetune_modelnet.yaml",
                                         "--synthetic", "--output_dir", str(tmp_path)]),
                  lambda: visualize.main(["--config", "configs/pointmae/config.yaml",
                                          "--synthetic", "--output_dir", str(tmp_path),
                                          "--out_dir", str(tmp_path / "vis")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert not (tmp_path / "vis").exists()


@pytest.mark.parametrize("wrapper", ["patch_embed", "attention_fwd", "attention_bwd"])
def test_a_cuda_tensor_goes_to_the_kernel_or_raises(wrapper, monkeypatch):
    """On a CUDA tensor a wrapper must reach for the kernel library (here:
    fail to, there is no nvcc) and never take the plain version; a CPU tensor
    takes the plain version and counts no launch."""
    from gm3d_tpu_torch.ops import _build, fused_attention as fa, patch_embed as pe

    fn = {"patch_embed": pe.fused_patch_embed, "attention_fwd": fa.fused_attention,
          "attention_bwd": fa.fused_attention_backward}[wrapper]
    before = fn.launches
    x = torch.randn(2, 4, 16)
    w = (torch.randn(16, 48), None, torch.randn(16, 16))
    if wrapper == "patch_embed":
        from gm3d_tpu_torch.models.blocks import PatchEncoder

        fn(torch.randn(1, 2, 4, 3), pe.params_from_module(PatchEncoder(16).eval()))
    elif wrapper == "attention_fwd":
        fn(x, *w, torch.zeros(16), heads=2)
    else:
        fn(x, torch.ones_like(x), *w, heads=2)
    assert fn.launches == before
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the kernel route is checked by chip_smoke.py")

    class Reached(Exception):
        pass

    def no_library(*a, **k):
        raise Reached

    # stand-ins that claim to be CUDA tensors: the wrapper must go for the library
    monkeypatch.setattr(_build, "load_library", no_library)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    with pytest.raises(Reached):
        if wrapper == "patch_embed":
            fn(torch.randn(1, 2, 4, 3), pe.params_from_module(PatchEncoder(16).eval()))
        elif wrapper == "attention_fwd":
            fn(x, *w, torch.zeros(16), heads=2)
        else:
            fn(x, torch.ones_like(x), *w, heads=2)


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=str(REPO), timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_parallel_and_serving_fan_out_default_to_cuda_and_say_so(artifact, monkeypatch):
    """The data-parallel set-up and the serving fan-out take the GPU unless
    the CPU is asked for: a rank of ``torchrun`` without a card raises before
    it joins any group."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    from gm3d_tpu_torch.cli.common import base_parser, setup_mesh
    from gm3d_tpu_torch.parallel import get_context, init_distributed
    from gm3d_tpu_torch.parallel.multihost import rank_device
    from gm3d_tpu_torch.serve.server import make_server, serving_devices

    _, art = artifact
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    for entry in (lambda: init_distributed(),
                  lambda: setup_mesh(base_parser("x").parse_args(["--config", "c.yaml"])),
                  lambda: rank_device("cuda", 0),
                  lambda: make_server(art, num_devices=2),
                  lambda: serving_devices(-1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert get_context() is None
    assert rank_device("cpu", 1).type == "cpu"
    assert serving_devices(2, "cpu") == [torch.device("cpu")] * 2

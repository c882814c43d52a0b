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


def _run(code, **env):
    full_env = dict(os.environ, PYTHONPATH=str(REPO), **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), env=full_env, timeout=300)


def test_every_module_imports_without_jax_or_the_jax_package():
    # an empty PATH and no CUDA_HOME: no nvcc can be found, the import must not look
    res = _run(_IMPORT_ALL, PATH="", CUDA_HOME="", CUDA_PATH="")
    assert res.returncode == 0, res.stderr
    lines = dict(ln.split(" ", 1) for ln in res.stdout.strip().splitlines())
    assert int(lines["IMPORTED"]) >= 48
    assert PRETRAIN_CLI_MODULES | CKPT_MODULES | PROBE_MODULES <= set(lines["NAMES"].split())
    assert lines["FOREIGN"] == "[]"


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

"""Builds the hand-written CUDA kernels under ``csrc/`` and loads them.

No JAX counterpart: Pallas kernels are compiled by the JAX runtime, CUDA C++
is compiled here. Every ``csrc/*.cu`` has a plain C interface, so the build
is ``nvcc`` alone (no PyTorch headers): each source is compiled to an object
file, all at the same time, and the objects are linked into one shared
library that ``ctypes`` loads.

The library goes to ``gm3d_tpu_torch/build/`` (git-ignored) under a name
that carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused. Nothing happens at import: the first kernel
launch calls :func:`load_library`. A failed build or load raises; no caller
falls back to anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # the kernels pick by comparing floats: never contract a*b+c into an FMA
    "-fmad=false",
    "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, the ``PATH``, or the
    toolkit's usual place; raises if there is none."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in CUDA_HOME, CUDA_PATH, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of gm3d_tpu_torch are built "
        "from source at first use and need the CUDA toolkit")


def sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libgm3d_kernels_{_digest(sources())}.so"


def build_library(verbose: bool = False) -> Path:
    """Compile every source (one ``nvcc`` each, started together), link, and
    move the library into place atomically. Returns its path."""
    srcs = sources()
    target = library_path()
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs, failed = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            if verbose and out:
                print(out, flush=True)
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
            objs.append(obj)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        so = os.path.join(tmp, target.name)
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", so, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
        os.replace(so, target)
    return target


def _bind(lib: ctypes.CDLL) -> None:
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.gm3d_fps.argtypes = [p, p, i, i, i, i, p]
    lib.gm3d_fps.restype = i
    lib.gm3d_knn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.gm3d_knn.restype = i
    lib.gm3d_patch_embed.argtypes = [p] * 14 + [i, i, i, i, p]
    lib.gm3d_patch_embed.restype = i
    lib.gm3d_attn_fwd.argtypes = [p, p, l, l, p, p, l, l, p, p, p, i, i, i, i, i, p]
    lib.gm3d_attn_fwd.restype = i
    lib.gm3d_attn_bwd.argtypes = [p, p, p, l, l, p, p, l, l, p, p, p, l, l, p, p, l, l, p,
                                  i, i, i, i, i, p]
    lib.gm3d_attn_bwd.restype = i
    lib.gm3d_tile_mma_test.argtypes = [p, l, l, i, p, l, l, i, i, p, i, i, i, p]
    lib.gm3d_tile_mma_test.restype = i


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if need be (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(verbose=verbose)))
            _bind(lib)
            _lib = lib
        return _lib


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches.
    Under a lock: the pretrain CLI's SVM probe thread launches the FPS and KNN
    kernels while the training loop does, and ``+= 1`` is not atomic."""
    with _count_lock:
        wrapper.launches += 1


def check_launch(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(
            f"CUDA kernel {name!r} was refused at launch (cudaError {rc})")

"""Paths of the checkout and the caches a run may write.

Every build and kernel cache lies at a fixed path inside the checkout, so
that only a checkout's first run builds. The port builds its CUDA library
into ``gm3d_tpu_torch/build/`` by itself; the variables below cover the
library caches of PyTorch that a run could reach.
"""

from __future__ import annotations

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CACHE = ROOT / ".benchcache"

# module top-level names a run may never load, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gm3d_tpu")


def set_cache_dirs() -> None:
    """Point the caches of PyTorch's compilers at fixed directories inside
    the checkout. Called before torch is imported."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def forbidden_loaded(modules) -> list:
    """The names in ``modules`` (e.g. ``sys.modules``) whose top-level name is
    a forbidden one, compared whole: ``gm3d_tpu_torch`` is not ``gm3d_tpu``."""
    return sorted(name for name in modules if name.split(".")[0] in FORBIDDEN_MODULES)

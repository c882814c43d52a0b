"""ctypes binding for the C++ threaded cloud loader (``loader.cpp``).

Port of ``gm3d_tpu/native/native_loader.py`` over the port's own copy of
``loader.cpp``. The library is built with ``g++`` at first use into
``gm3d_tpu_torch/build/`` (git-ignored) under a name that carries a hash of
the source and the flags, as ``ops/_build.py`` keys the CUDA library: an
edited source is rebuilt, an unchanged one reused. It is not under ``csrc/``,
whose every source goes to ``nvcc``: this one builds on a machine without
CUDA.

Two differences from the JAX package. Where the library cannot be built, the
JAX loader reports itself unavailable and its CLIs use the Python loader;
here the build failure raises, with the compiler's output, and nothing falls
back. And the batches come in the epoch's order whatever order the worker
threads finish in, so they are f(seed, epoch) for any worker count (the JAX
loader's are with one worker only): data-parallel ranks, each running the
same loader and keeping its rows, then split every epoch's clouds between
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path(source: Optional[Path] = None) -> Path:
    """Where the library of ``source`` (default ``SOURCE``) is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((source or SOURCE).read_bytes())
    return BUILD_DIR / f"libgm3dio_{h.hexdigest()[:16]}.so"


def build_library(source: Optional[Path] = None) -> Path:
    """Compile ``source`` (default ``SOURCE``) into the build directory
    (once; moved into place atomically) and return the library's path.
    Raises ``RuntimeError`` with the compiler's output when the build fails."""
    source = source or SOURCE
    target = library_path(source)
    if target.exists():
        return target
    cxx = os.environ.get("CXX", "g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, target.name)
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", so, str(source)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"the native loader cannot be built: {cxx!r} did not run "
                               f"({e})") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building the native loader from {source} failed "
                               f"({cxx}, exit {proc.returncode}):\n{proc.stdout}")
        os.replace(so, target)
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gm3d_loader_create.restype = ctypes.c_void_p
    lib.gm3d_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_int,
    ]
    lib.gm3d_loader_next.restype = ctypes.c_int
    lib.gm3d_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.gm3d_labelled_loader_create.restype = ctypes.c_void_p
    lib.gm3d_labelled_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
    ]
    lib.gm3d_loader_next_labelled.restype = ctypes.c_int
    lib.gm3d_loader_next_labelled.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.gm3d_loader_num_batches.restype = ctypes.c_int
    lib.gm3d_loader_num_batches.argtypes = [ctypes.c_void_p]
    lib.gm3d_loader_error_count.restype = ctypes.c_long
    lib.gm3d_loader_error_count.argtypes = [ctypes.c_void_p]
    lib.gm3d_loader_set_epoch.restype = None
    lib.gm3d_loader_set_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gm3d_loader_epoch.restype = ctypes.c_int
    lib.gm3d_loader_epoch.argtypes = [ctypes.c_void_p]
    lib.gm3d_loader_destroy.restype = None
    lib.gm3d_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if need be (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build_library())))
        return _lib


class _NativeLoader:
    """What both loaders share: the handle's lifetime, the length, the error
    count and the epoch control.

    Resume contract shared with the Python ``DataLoader``: the shuffle order
    is f(seed, epoch), so restoring the epoch restores the sequence. The CLIs
    call ``load_state({"epoch": e, "batch": 0})`` on ``--resume``; a
    mid-epoch position is not restored (the resumed epoch restarts from its
    first batch)."""

    _handle = None

    def _open(self, create, paths: List[str]) -> None:
        self._lib = load_library()
        self._errors_seen = 0
        self.paths = list(paths)
        # the path strings must outlive the call that copies them
        self._c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = create(self._c_paths)

    def __len__(self):
        return self._lib.gm3d_loader_num_batches(self._handle)

    def _check_errors(self) -> None:
        """Raise when workers skipped unreadable or invalid files: a silent
        skip would shorten the epoch while ``__len__`` still counts every
        path, skewing the schedules and hiding data loss."""
        n = int(self._lib.gm3d_loader_error_count(self._handle))
        if n > self._errors_seen:
            self._errors_seen = n
            raise RuntimeError(
                f"native loader: {n} file(s) unreadable or invalid this run — "
                "fix or remove them (the torch reference would crash on the "
                "first one; a silent skip would shorten epochs invisibly)")

    @property
    def epoch(self) -> int:
        return int(self._lib.gm3d_loader_epoch(self._handle))

    def set_epoch(self, epoch: int) -> None:
        self._lib.gm3d_loader_set_epoch(self._handle, int(epoch))

    def state(self) -> dict:
        return {"epoch": self.epoch, "batch": 0}

    def load_state(self, state: dict) -> None:
        self.set_epoch(int(state.get("epoch", 0)))

    def close(self) -> None:
        if self._handle:
            self._lib.gm3d_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeCloudLoader(_NativeLoader):
    """Iterates (batch_size, npoints, 3) float32 batches read, subsampled and
    unit-sphere-normalised by C++ worker threads (at least one: without a
    producer the first batch would never come)."""

    def __init__(self, paths: List[str], npoints: int, batch_size: int,
                 num_workers: int = 4, seed: int = 0, shuffle: bool = True):
        self.npoints, self.batch_size = npoints, batch_size
        workers = max(1, int(num_workers))
        self._open(lambda arr: self._lib.gm3d_loader_create(
            arr, len(paths), npoints, batch_size, workers, seed, int(shuffle)), paths)
        self._buf = np.empty((batch_size, npoints, 3), np.float32)

    def __iter__(self):
        ptr = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        while self._lib.gm3d_loader_next(self._handle, ptr):
            yield self._buf.copy()
        self._check_errors()


class NativeLabelledCloudLoader(_NativeLoader):
    """Labelled variant: yields ``(pts, cls)``, or ``(pts, cls, seg)`` with
    ``with_seg=True``. The class label travels with each sample through the
    loader's buffer, so it cannot be mis-paired with its points. With
    ``with_seg`` the last npy column is returned as per-point int32 part ids
    (the ShapeNetPart ``.npy`` caches are (N, 7) ``x y z nx ny nz part``)."""

    def __init__(self, paths: List[str], labels: List[int], npoints: int, batch_size: int,
                 num_workers: int = 4, seed: int = 0, shuffle: bool = True,
                 with_seg: bool = False):
        if len(paths) != len(labels):
            raise ValueError(f"{len(paths)} paths but {len(labels)} labels")
        self.npoints, self.batch_size, self.with_seg = npoints, batch_size, with_seg
        workers = max(1, int(num_workers))
        self._labels = np.ascontiguousarray(labels, np.int32)
        lbl = self._labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        self._open(lambda arr: self._lib.gm3d_labelled_loader_create(
            arr, lbl, len(paths), npoints, batch_size, workers, seed, int(shuffle),
            int(with_seg)), paths)
        self._pts = np.empty((batch_size, npoints, 3), np.float32)
        self._cls = np.empty((batch_size,), np.int32)
        self._seg = np.empty((batch_size, npoints), np.int32)

    def __iter__(self):
        ptrs = (self._pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._cls.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self._seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        while self._lib.gm3d_loader_next_labelled(self._handle, *ptrs):
            if self.with_seg:
                yield self._pts.copy(), self._cls.copy(), self._seg.copy()
            else:
                yield self._pts.copy(), self._cls.copy()
        self._check_errors()

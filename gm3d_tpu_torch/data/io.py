"""File readers (.npy / .h5 / .txt).

Own copy of ``gm3d_tpu/data/io.py`` (numpy only). ``h5py`` is imported inside
``read_h5``: only the ScanObjectNN readers need it."""

from __future__ import annotations

import os

import numpy as np


def read_npy(path: str) -> np.ndarray:
    return np.load(path)


def read_h5(path: str, datasets=("data", "label")):
    import h5py

    with h5py.File(path, "r") as f:
        return tuple(np.asarray(f[d]) for d in datasets)


def read_txt_points(path: str, delimiter: str = ",") -> np.ndarray:
    return np.loadtxt(path, delimiter=delimiter).astype(np.float32)


def get(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1]
    if ext == ".npy":
        return read_npy(path)
    if ext in (".txt", ".pts"):
        return read_txt_points(path)
    raise ValueError(f"unsupported extension {ext}")

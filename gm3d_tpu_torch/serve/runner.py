"""Serving-side runner over an exported artifact.

Port of ``gm3d_tpu/serve/runner.py``. The artifact has a STATIC batch;
:class:`ServingModel` maps arbitrary request sizes onto it:

  - a single cloud ``(N, 3)`` is promoted to a batch of one
  - ``B <= batch``: zero-pad to ``batch``, slice the outputs back
  - ``B > batch``: chunk into ceil(B / batch) calls

Padding clouds are all-zeros; their outputs are discarded, never returned.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from gm3d_tpu_torch.serve.export import load_artifact


def check_points(points: np.ndarray, npoints: int):
    """Validate and batch-promote request points.

    Returns ``(points (B, npoints, 3) float32, was_single)``; raises
    ``ValueError`` on any shape-contract violation. Shared by
    :class:`ServingModel` and the
    :class:`~gm3d_tpu_torch.serve.batcher.DynamicBatcher` (which must validate
    on the REQUEST thread, before enqueueing)."""
    points = np.asarray(points, dtype=np.float32)
    single = points.ndim == 2
    if single:
        points = points[None]
    if points.ndim != 3 or points.shape[2] != 3:
        raise ValueError(f"expected (B, N, 3) points, got {points.shape}")
    if points.shape[0] == 0:
        raise ValueError("empty request batch (B=0)")
    if points.shape[1] != npoints:
        raise ValueError(
            f"expected {npoints} points per cloud (the exported "
            f"input size), got {points.shape[1]}")
    return points, single


def check_labels(cls_label, b: int, single: bool, dtype,
                 num_classes: "int | None" = None) -> np.ndarray:
    """Validate per-cloud labels against a request of ``b`` clouds.

    A scalar label is promoted alongside a single-cloud request; otherwise
    the shape must be ``(b,)``. With ``num_classes`` the values must lie in
    ``[0, num_classes)``. Raises ``ValueError`` on any violation (same
    request-thread contract as :func:`check_points`). No artifact served by
    this package takes labels yet; the segmentation slice is its caller."""
    lab = np.asarray(cls_label)
    if single and lab.ndim == 0:
        lab = lab[None]
    if lab.shape != (b,):
        raise ValueError(
            f"expected cls_label of shape ({b},) matching the request "
            f"batch, got {lab.shape}")
    if not np.issubdtype(lab.dtype, np.number):
        raise ValueError(f"cls_label must be numeric, got dtype {lab.dtype}")
    if lab.size and not (np.all(np.isfinite(lab)) and np.all(lab == np.floor(lab))):
        # fractional labels would silently truncate in the int cast below and
        # NaN compares False against both range bounds: reject both up front
        raise ValueError("cls_label values must be finite integers")
    if num_classes is not None and lab.size:
        lo, hi = lab.min(), lab.max()
        if lo < 0 or hi >= num_classes:
            raise ValueError(
                f"cls_label values must be in [0, {num_classes}), got range [{lo}, {hi}]")
    return lab.astype(dtype, copy=False)


class ServingModel:
    """Loads a ``.gm3dx`` artifact and serves numpy in / numpy out.

    ``device``: where the model runs (default ``"cuda"``; raises without
    one). ``devices``: the fan-out list of the JAX runner; one device is
    accepted (and takes the place of ``device``), more raise ``ValueError``
    until multi-GPU fan-out is ported."""

    def __init__(self, path: str, device="cuda", devices: Optional[Sequence] = None):
        if devices:
            if len(devices) > 1:
                raise ValueError(
                    f"fan-out over {len(devices)} devices is not ported yet: "
                    "ServingModel takes one device")
            device = devices[0]
        self.path = path
        self._fn, self.manifest = load_artifact(path, device=device)
        self.batch, self.npoints, _ = self.manifest["input_shape"]
        self.device_call = self._fn.device_call
        self.module = self._fn.module

    @property
    def info(self) -> Dict[str, Any]:
        return dict(self.manifest)

    def predict(self, points: np.ndarray) -> np.ndarray:
        """points (B, N, 3) or (N, 3) -> outputs (B, ...) / (...)."""
        points, single = check_points(points, self.npoints)
        b = points.shape[0]
        outs = []
        for start in range(0, b, self.batch):
            chunk = points[start:start + self.batch]
            n = chunk.shape[0]
            if n < self.batch:
                pad = np.zeros((self.batch - n,) + chunk.shape[1:], np.float32)
                chunk = np.concatenate([chunk, pad], axis=0)
            outs.append(self._fn(chunk)[:n])
        out = np.concatenate(outs, axis=0)
        return out[0] if single else out

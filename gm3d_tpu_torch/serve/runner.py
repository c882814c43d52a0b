"""Serving-side runner over an exported artifact.

Port of ``gm3d_tpu/serve/runner.py``. The artifact has a STATIC batch;
:class:`ServingModel` maps arbitrary request sizes onto it:

  - a single cloud ``(N, 3)`` is promoted to a batch of one
  - ``B <= batch``: zero-pad to ``batch``, slice the outputs back
  - ``B > batch``: chunk into ceil(B / batch) calls

Padding clouds are all-zeros; their outputs are discarded, never returned.
A segmentation artifact also takes each cloud's object category
(``cls_label``), padded and chunked in lockstep with the points. With
``devices``, the program is loaded once a device and the chunks go to them
round-robin, all enqueued before any is read back.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from gm3d_tpu_torch.serve.export import load_artifact
from gm3d_tpu_torch.utils.device import resolve_device
from gm3d_tpu_torch.utils.profiling import span


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
    request-thread contract as :func:`check_points`). Shared by
    :class:`ServingModel` and the dynamic batcher for segmentation
    artifacts."""
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
    one). ``devices``: a sequence of devices to fan the chunks out over
    (round-robin, as the JAX runner does; a device may repeat, which gives
    it two replicas); ``None`` serves on ``device`` alone."""

    def __init__(self, path: str, device="cuda", devices: Optional[Sequence] = None):
        self.path = path
        self.devices = [resolve_device(d) for d in (devices or [device])]
        loaded = [load_artifact(path, device=d) for d in self.devices]
        self._fns = [fn for fn, _ in loaded]
        self.manifest = loaded[0][1]
        # a cursor that persists over calls: a one-chunk request (and every
        # batcher-coalesced batch) would otherwise always take devices[0];
        # ``itertools.count`` advances in one C call, safe across request threads
        self._rr = itertools.count()
        self.batch, self.npoints, _ = self.manifest["input_shape"]
        self.device_call = self._fns[0].device_call
        self.program = self._fns[0].program  # the loaded torch.export program
        # at most one extra per-cloud input: the seg model's cls_label
        extra = self.manifest.get("extra_inputs", [])
        if len(extra) > 1:
            raise ValueError(
                f"artifact has {len(extra)} extra inputs; ServingModel supports at most "
                "one (per-cloud cls_label)")
        self._label_dtype = np.dtype(extra[0]["dtype"]) if extra else None
        # the category count bounds the labels (seg exports carry the names)
        names = self.manifest.get("cls_names")
        self._num_categories = len(names) if names else None

    @property
    def needs_labels(self) -> bool:
        """True for artifacts with a per-cloud label input (segmentation)."""
        return self._label_dtype is not None

    def check_request_labels(self, cls_label, b: int, single: bool):
        """The request's labels checked against the artifact: required by a
        segmentation artifact (``check_labels``), refused by any other.
        Returns the labels or None."""
        if self.needs_labels:
            if cls_label is None:
                raise ValueError(
                    "this artifact requires cls_label (per-cloud object category) "
                    "alongside the points")
            return check_labels(cls_label, b, single, self._label_dtype,
                                self._num_categories)
        if cls_label is not None:
            raise ValueError("this artifact takes no cls_label input")
        return None

    @property
    def info(self) -> Dict[str, Any]:
        info = dict(self.manifest)
        if len(self.devices) > 1:
            info["serving_devices"] = len(self.devices)
        return info

    def predict(self, points: np.ndarray, cls_label=None) -> np.ndarray:
        """points (B, N, 3) or (N, 3) -> outputs (B, ...) / (...).
        Segmentation artifacts also take ``cls_label``, the per-cloud object
        category, (B,) int (a scalar with a single cloud)."""
        points, single = check_points(points, self.npoints)
        b = points.shape[0]
        labels = self.check_request_labels(cls_label, b, single)
        outs = []
        for start in range(0, b, self.batch):
            chunk = points[start:start + self.batch]
            n = chunk.shape[0]
            with span("runner.pad"):
                if n < self.batch:
                    pad = np.zeros((self.batch - n,) + chunk.shape[1:], np.float32)
                    chunk = np.concatenate([chunk, pad], axis=0)
                extra = ()
                if labels is not None:
                    lab = labels[start:start + self.batch]
                    extra = (np.concatenate([lab, np.zeros(self.batch - n, lab.dtype)]),)
            i = next(self._rr) % len(self._fns)
            dev = self.devices[i]
            with span("runner.copy_in"):
                args = [torch.from_numpy(np.ascontiguousarray(
                    chunk, dtype=self.manifest["input_dtype"])).to(dev)]
                args += [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in extra]
            # enqueued on its device; read back once every chunk is in flight
            with span("runner.launch"):
                outs.append(self._fns[i].device_call(*args)[:n])
        with span("runner.read_back"):
            out = np.concatenate([o.cpu().numpy() for o in outs], axis=0)
        return out[0] if single else out

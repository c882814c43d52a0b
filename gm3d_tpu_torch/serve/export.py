"""Model export to self-contained serving artifacts.

Port of ``gm3d_tpu/serve/export.py``. An artifact (``.gm3dx``) is a zip with
two members:

  ``manifest.json``   input/output shapes + dtypes, the device type it was
                      exported on, model metadata (registry name and
                      constructor arguments as a config ``model`` section,
                      mode, npoints, ckpt step)
  ``weights.pt``      the model's state dict (``torch.save``)

Loading needs this package and the artifact, no config and no checkpoint:
``load_artifact`` rebuilds the module from the manifest, loads the weights
(``strict=True``), moves it to the device, sets ``eval()`` and returns a
callable. The batch is static by contract: ragged request batches are
padded/chunked by :class:`gm3d_tpu_torch.serve.runner.ServingModel`, and the
dynamic batcher's cap is built on it.

The classifier forward is the validation forward (FPS straight to npoints
when the input is larger, no augmentation, running BN stats); the feature
forward is the frozen (mean+max)-pooled encoder the probes consume; the
segmentation forward takes the points and each cloud's object category and
returns per-point part logits, with no FPS (the input is the model's point
count). Its manifest records the category input under ``extra_inputs``.

An int8 artifact (manifest ``"quantization": "int8"``, ``cli/export_model.py
--quantize int8``) holds the int8 weights and per-channel scales of every
dense layer (``serve/quantize.py``); ``load_artifact`` converts the rebuilt
model to that layout before its strict load and runs the forward inside
``quantized_dense()``.
"""

from __future__ import annotations

import contextlib
import io
import json
import zipfile
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gm3d_tpu_torch.config.registry import build_model_from_cfg
from gm3d_tpu_torch.ops.fps import fps
from gm3d_tpu_torch.serve.quantize import quantize_module, quantized_dense
from gm3d_tpu_torch.utils.device import dtype_from_name, resolve_device

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"
MODES = ("classifier", "features", "segmentation")
QUANTIZATIONS = ("none", "int8")


def build_classifier_fn(model: nn.Module, npoints: int) -> Callable:
    """Eval forward: points (B, N, 3) -> logits (B, C), fp32."""

    def fn(pts: torch.Tensor) -> torch.Tensor:
        x = fps(pts, npoints) if pts.shape[1] > npoints else pts
        return model(x).to(torch.float32)

    return fn


def build_feature_fn(model: nn.Module, npoints: int) -> Callable:
    """Frozen featurizer: points (B, N, 3) -> (mean+max)-pooled features
    (B, D), fp32: what the SVM/kNN/linear probes consume."""

    def fn(pts: torch.Tensor) -> torch.Tensor:
        x = fps(pts, npoints) if pts.shape[1] > npoints else pts
        f = model.encode_features(x)
        return (f.mean(dim=1) + f.max(dim=1).values).to(torch.float32)

    return fn


def build_seg_fn(model: nn.Module) -> Callable:
    """Part-segmentation eval forward: (points (B, N, 3), cls_label (B,)
    int32 object category) -> per-point part logits (B, N, num_parts), fp32.
    No FPS: the outputs are PER POINT, so a subsample would label another
    cloud than the caller sent; the input must be the model's point count."""

    def fn(pts: torch.Tensor, cls_label: torch.Tensor) -> torch.Tensor:
        return model(pts, cls_label.to(torch.int64)).to(torch.float32)

    return fn


def _build_fn(mode: str, model: nn.Module, npoints: int) -> Callable:
    if mode == "segmentation":
        return build_seg_fn(model)
    if mode == "classifier":
        return build_classifier_fn(model, npoints)
    if mode == "features":
        return build_feature_fn(model, npoints)
    raise ValueError(
        f"artifact mode {mode!r} is not served by this package yet "
        f"(supported: {list(MODES)})")


def _check_parts_table(manifest: Dict[str, Any]) -> None:
    """A segmentation manifest carries the category -> parts table
    (``seg_classes``, ``cls_names``) that the server's part labels need."""
    if manifest.get("mode") == "segmentation" and not (manifest.get("seg_classes")
                                                       and manifest.get("cls_names")):
        raise ValueError("a segmentation artifact needs the manifest's category -> parts "
                         "table (seg_classes and cls_names)")


def save_artifact(path: str, model: nn.Module, manifest: Dict[str, Any],
                  input_shape: Sequence[int], device: "str | torch.device") -> str:
    """Write the ``.gm3dx`` zip. ``manifest`` carries ``mode``, ``model``,
    ``model_cfg`` (what :func:`build_model_from_cfg` rebuilds ``model`` from),
    ``npoints``, ``ckpt_step``, ``compute_dtype``; the shape, dtype, platform
    and version fields are filled in here so they cannot drift. A
    segmentation artifact takes a second input, the (batch,) int32
    categories (``extra_inputs``), and its manifest must hold the category
    -> parts table (``seg_classes``, ``cls_names``)."""
    manifest = dict(manifest)
    mode = manifest["mode"]
    if mode not in MODES:
        raise ValueError(f"unsupported export mode {mode!r} (expected one of {list(MODES)})")
    _check_parts_table(manifest)
    batch, n_input, three = (int(s) for s in input_shape)
    if three != 3 or batch < 1 or n_input < manifest["npoints"]:
        raise ValueError(
            f"input shape {list(input_shape)} must be (batch >= 1, "
            f"points >= npoints={manifest['npoints']}, 3)")
    if mode == "segmentation":
        out_shape = [batch, n_input, int(model.num_parts)]
        manifest["extra_inputs"] = [{"shape": [batch], "dtype": "int32"}]
    else:
        out_dim = model.cls_dim if mode == "classifier" else model.trans_dim
        out_shape = [batch, int(out_dim)]
    manifest.update(
        format_version=FORMAT_VERSION,
        input_shape=[batch, n_input, 3],
        input_dtype="float32",
        output_shape=out_shape,
        output_dtype="float32",
        platforms=[torch.device(device).type],
        torch_version=torch.__version__,
    )
    blob = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, blob)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_MANIFEST, json.dumps(manifest, indent=1))
        zf.writestr(_WEIGHTS, blob.getvalue())
    return path


def load_artifact(path: str, device: "str | torch.device" = "cuda"
                  ) -> Tuple[Callable, Dict[str, Any]]:
    """Load an artifact onto ``device``: returns ``(fn, manifest)``.

    ``fn`` takes one array of exactly ``manifest["input_shape"]`` (static
    shapes; use :class:`ServingModel` for ragged batches), and one more of
    each shape of ``manifest["extra_inputs"]`` (a segmentation artifact's
    categories), and returns a numpy array. ``fn.device_call`` is the same
    forward from tensors on the device to a tensor on the device, without the
    host copies; ``fn.module`` is the rebuilt ``nn.Module``."""
    device = resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        manifest = json.loads(zf.read(_MANIFEST).decode("utf-8"))
        blob = zf.read(_WEIGHTS)
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported artifact format {manifest.get('format_version')!r} "
            f"(expected {FORMAT_VERSION})")
    model = build_model_from_cfg(manifest["model_cfg"],
                                 dtype=dtype_from_name(manifest["compute_dtype"]))
    # refuse an unserved mode, or a seg manifest without its table, before any work
    module_fn = _build_fn(manifest.get("mode"), model, manifest["npoints"])
    _check_parts_table(manifest)
    quantization = manifest.get("quantization", "none")
    if quantization not in QUANTIZATIONS:
        raise ValueError(f"unsupported artifact quantization {quantization!r} "
                         f"(expected one of {list(QUANTIZATIONS)})")
    int8 = quantization == "int8"
    if int8:  # the int8 layout first, so that the strict load matches it
        quantize_module(model)
    state = torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    model.to(device).eval()
    shape = tuple(manifest["input_shape"])
    extra_specs = manifest.get("extra_inputs", [])

    def device_call(points: torch.Tensor, *extra: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), (quantized_dense() if int8 else contextlib.nullcontext()):
            return module_fn(points, *extra)

    def fn(points, *extra) -> np.ndarray:
        points = np.asarray(points, dtype=manifest["input_dtype"])
        if points.shape != shape:
            raise ValueError(
                f"input shape {points.shape} != exported shape {shape}; "
                "ServingModel.predict handles ragged batches by padding")
        if len(extra) != len(extra_specs):
            raise ValueError(
                f"artifact takes {1 + len(extra_specs)} inputs, got {1 + len(extra)}")
        args = [torch.from_numpy(points).to(device)]
        for x, spec in zip(extra, extra_specs):
            x = np.asarray(x, dtype=spec["dtype"])
            if x.shape != tuple(spec["shape"]):
                raise ValueError(f"extra input shape {x.shape} != exported {spec['shape']}")
            args.append(torch.from_numpy(x).to(device))
        return device_call(*args).cpu().numpy()

    fn.device_call = device_call
    fn.module = model
    return fn, manifest

"""Model export to self-contained serving artifacts (``torch.export``).

Port of ``gm3d_tpu/serve/export.py``. An artifact (``.gm3dx``) is a zip with
two members:

  ``manifest.json``   input/output shapes + dtypes, the platforms it serves
                      on (``cpu``, ``cuda``), model metadata (registry name
                      and constructor arguments as a config ``model``
                      section, mode, npoints, ckpt step, quantization; the
                      segmentation parts table)
  ``program.pt2``     the ``torch.export`` program of the eval forward with
                      the trained weights in it (``torch.export.save``)

Loading needs ONLY torch and the custom ops that ``gm3d_tpu_torch.ops``
registers on import (``gm3d::fps``, ``gm3d::knn``, ``gm3d::int8_mm``): no model
code, no config and no checkpoint. ``load_artifact`` deserializes the
program, moves it to the device, and refuses a device type that is not in
``manifest["platforms"]``. In the program FPS and KNN are single op nodes, so
it runs their CUDA kernels on the card and their plain versions on the CPU;
one artifact exported for ``cpu,cuda`` serves on both. Shapes are static by
contract (the program's own input guards check them): ragged request batches
are padded/chunked by :class:`gm3d_tpu_torch.serve.runner.ServingModel`, and
the dynamic batcher's cap is built on it.

The classifier forward is the validation forward (FPS straight to npoints
when the input is larger, no augmentation, running BN stats); the feature
forward is the frozen (mean+max)-pooled encoder the probes consume; the
segmentation forward takes the points and each cloud's object category and
returns per-point part logits, with no FPS (the input is the model's point
count). Its manifest records the category input under ``extra_inputs``.

An int8 program (manifest ``"quantization": "int8"``, ``cli/export_model.py
--quantize int8``) is traced inside ``quantized_dense()`` from a model whose
dense layers hold int8 weights and per-channel scales (``serve/quantize.py``):
the int8 layout and the ``gm3d::int8_mm`` products are in the program.
"""

from __future__ import annotations

import contextlib
import io
import json
import zipfile
from typing import Any, Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

import gm3d_tpu_torch.ops  # noqa: F401  (registers torch.ops.gm3d.*)
from gm3d_tpu_torch.ops.fps import fps
from gm3d_tpu_torch.utils.device import resolve_device

FORMAT_VERSION = 2
_MANIFEST = "manifest.json"
_PROGRAM = "program.pt2"
MODES = ("classifier", "features", "segmentation")
QUANTIZATIONS = ("none", "int8")
PLATFORMS = ("cpu", "cuda")


def build_classifier_fn(model: nn.Module, npoints: int) -> Callable:
    """Eval forward: points (B, N, 3) -> logits (B, C), fp32."""

    def fn(pts: torch.Tensor) -> torch.Tensor:
        x = fps(pts, npoints) if pts.shape[1] > npoints else pts
        return model(x).to(torch.float32)

    fn.model = model
    return fn


def build_feature_fn(model: nn.Module, npoints: int) -> Callable:
    """Frozen featurizer: points (B, N, 3) -> (mean+max)-pooled features
    (B, D), fp32: what the SVM/kNN/linear probes consume."""

    def fn(pts: torch.Tensor) -> torch.Tensor:
        x = fps(pts, npoints) if pts.shape[1] > npoints else pts
        f = model.encode_features(x)
        return (f.mean(dim=1) + f.max(dim=1).values).to(torch.float32)

    fn.model = model
    return fn


def build_seg_fn(model: nn.Module) -> Callable:
    """Part-segmentation eval forward: (points (B, N, 3), cls_label (B,)
    int32 object category) -> per-point part logits (B, N, num_parts), fp32.
    No FPS: the outputs are PER POINT, so a subsample would label another
    cloud than the caller sent; the input must be the model's point count."""

    def fn(pts: torch.Tensor, cls_label: torch.Tensor) -> torch.Tensor:
        return model(pts, cls_label.to(torch.int64)).to(torch.float32)

    fn.model = model
    return fn


def _check_mode(manifest: Dict[str, Any]) -> None:
    mode = manifest.get("mode")
    if mode not in MODES:
        raise ValueError(
            f"artifact mode {mode!r} is not served by this package yet "
            f"(supported: {list(MODES)})")
    _check_parts_table(manifest)


def _check_parts_table(manifest: Dict[str, Any]) -> None:
    """A segmentation manifest carries the category -> parts table
    (``seg_classes``, ``cls_names``) that the server's part labels need."""
    if manifest.get("mode") == "segmentation" and not (manifest.get("seg_classes")
                                                       and manifest.get("cls_names")):
        raise ValueError("a segmentation artifact needs the manifest's category -> parts "
                         "table (seg_classes and cls_names)")


def check_platforms(platforms: Sequence[str]) -> Tuple[str, ...]:
    """The platforms of an export, each one of :data:`PLATFORMS`, in order,
    without repeats."""
    out = tuple(dict.fromkeys(p.strip() for p in platforms))
    bad = [p for p in out if p not in PLATFORMS]
    if not out or bad:
        raise ValueError(f"platforms must be a non-empty list out of {list(PLATFORMS)}, "
                         f"got {list(platforms)}")
    return out


class Exported(NamedTuple):
    """What :func:`export_forward` returns: the program, kept on the CPU
    until it is loaded, and the platforms it is exported for."""
    program: torch.export.ExportedProgram
    platforms: Tuple[str, ...]


class _Forward(nn.Module):
    """A ``build_*_fn`` forward as a module: its model (``fn.model``) is a
    submodule, so that ``torch.export`` lifts the weights into the program
    under their names."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.model = fn.model
        self.fn = fn

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        return self.fn(*inputs)


def _drop_no_ops(program: torch.export.ExportedProgram) -> None:
    """Take out of the traced graph, in place, the nodes that compute nothing
    at run time and that each cost a call of host time: the trace's dtype
    assertions (the inputs' dtypes are fixed by the static contract), casts to
    the dtype a tensor already has (``x.to(dtype)`` returns ``x``), and dropout
    in eval mode: about half of the fp32 classifier's nodes."""
    aten = torch.ops.aten
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is aten._assert_tensor_metadata.default:
            graph.erase_node(node)
            continue
        same = (node.target is aten.to.dtype and len(node.args) == 2 and not node.kwargs
                and node.args[0].meta["val"].dtype == node.args[1])
        idle = node.target is aten.dropout.default and node.args[2:] == (False,)
        if (same or idle) and all(user.op != "output" for user in node.users):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    graph.eliminate_dead_code()
    program.graph_module.recompile()


def export_forward(fn: Callable, example_inputs, platforms: Sequence[str] | None = None,
                   quantize: str | None = None) -> Exported:
    """Trace ``fn`` (a ``build_*_fn`` forward) with ``torch.export.export`` on
    the device of ``example_inputs`` (one tensor, or a tuple for the seg
    model's (points, cls_label)), under ``torch.no_grad()`` with the model in
    ``eval()``, then takes the trace's no-op nodes out (:func:`_drop_no_ops`).
    ``platforms`` defaults to that device's type; since FPS, KNN
    and the int8 product are custom ops that pick their implementation by the
    device they run on, one program serves every platform listed, and the
    list is the artifact's contract (``load_artifact`` refuses others).

    ``quantize="int8"`` traces under :func:`serve.quantize.quantized_dense`:
    every dense product becomes a dynamic-int8 w8a8 product, and the int8
    weights of a model converted by ``quantize_module`` go into the program
    as they are (the JAX export constant-folds its int8 kernels)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize mode {quantize!r} (expected None or 'int8')")
    examples = (tuple(example_inputs) if isinstance(example_inputs, (tuple, list))
                else (example_inputs,))
    platforms = check_platforms(platforms or (examples[0].device.type,))
    wrapper = _Forward(fn).eval()
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.no_grad())
        if quantize == "int8":
            from gm3d_tpu_torch.serve.quantize import quantized_dense

            stack.enter_context(quantized_dense())
        program = torch.export.export(wrapper, examples, strict=False)
    _drop_no_ops(program)
    if examples[0].device.type != "cpu":
        program = move_to_device_pass(program, "cpu")
    return Exported(program, platforms)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _user_values(program: torch.export.ExportedProgram):
    """The example values of the program's user inputs and outputs."""
    sig = program.graph_signature
    placeholders = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
    inputs = [placeholders[name].meta["val"] for name in sig.user_inputs]
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    by_name = {n.name: n for n in out_node.args[0] if isinstance(n, torch.fx.Node)}
    outputs = [by_name[name].meta["val"] for name in sig.user_outputs]
    return inputs, outputs


def save_artifact(path: str, exported: Exported, manifest: Dict[str, Any]) -> str:
    """Write the ``.gm3dx`` zip. ``manifest`` carries ``mode``, ``model``,
    ``model_cfg`` (metadata: the model the program was traced from),
    ``npoints``, ``ckpt_step``, ``compute_dtype``, ``quantization``; the
    shape, dtype, platform and version fields are filled in here from the
    program itself, so they cannot drift. ``input_shape`` / ``input_dtype``
    describe the first input (the points); a further input (the seg model's
    per-cloud category) goes under ``extra_inputs`` and must lead with the
    points' batch, along which :class:`ServingModel` pads and chunks. A
    segmentation manifest must hold the category -> parts table
    (``seg_classes``, ``cls_names``)."""
    manifest = dict(manifest)
    _check_mode(manifest)
    inputs, outputs = _user_values(exported.program)
    batch, n_input, three = (int(s) for s in inputs[0].shape)
    if three != 3 or batch < 1 or n_input < manifest["npoints"]:
        raise ValueError(
            f"input shape {list(inputs[0].shape)} must be (batch >= 1, "
            f"points >= npoints={manifest['npoints']}, 3)")
    extra = [{"shape": [int(s) for s in v.shape], "dtype": _dtype_name(v.dtype)}
             for v in inputs[1:]]
    for spec in extra:
        if not spec["shape"] or spec["shape"][0] != batch:
            raise ValueError(
                f"extra input {spec} must lead with the points batch dim "
                f"{batch} (ServingModel batches along axis 0)")
    manifest.update(
        format_version=FORMAT_VERSION,
        input_shape=[batch, n_input, 3],
        input_dtype=_dtype_name(inputs[0].dtype),
        output_shape=[int(s) for s in outputs[0].shape],
        output_dtype=_dtype_name(outputs[0].dtype),
        platforms=list(check_platforms(exported.platforms)),
        torch_version=torch.__version__,
    )
    if extra:
        manifest["extra_inputs"] = extra
    blob = io.BytesIO()
    torch.export.save(exported.program, blob)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr(_MANIFEST, json.dumps(manifest, indent=1),
                    compress_type=zipfile.ZIP_DEFLATED)
        # stored: the program is an archive of raw tensors, which deflate
        # shrinks by some 7% at some 20 MB/s
        zf.writestr(_PROGRAM, blob.getvalue(), compress_type=zipfile.ZIP_STORED)
    return path


def _lifted_call(program: torch.export.ExportedProgram) -> Callable:
    """The program's graph called with its weights and constants in their
    places: less host time a call than ``program.module()``, which flattens
    the inputs and checks its guards each time (``load_artifact`` checks the
    static shapes itself)."""
    from torch.export.graph_signature import InputKind, OutputKind

    sig = program.graph_signature
    slots = [None if spec.kind == InputKind.USER_INPUT
             else program.state_dict[spec.target] if spec.target in program.state_dict
             else program.constants[spec.target] for spec in sig.input_specs]
    out = next(i for i, spec in enumerate(sig.output_specs)
               if spec.kind == OutputKind.USER_OUTPUT)
    graph = program.graph_module
    graph.recompile()  # a move to another device edits the nodes, not the code

    def call(*inputs: torch.Tensor) -> torch.Tensor:
        it = iter(inputs)
        return graph(*[next(it) if slot is None else slot for slot in slots])[out]

    return call


def load_artifact(path: str, device: "str | torch.device" = "cuda"
                  ) -> Tuple[Callable, Dict[str, Any]]:
    """Load an artifact onto ``device``: returns ``(fn, manifest)``.

    ``device``'s type must be one of ``manifest["platforms"]``. Nothing is
    rebuilt from model code: the program is deserialized and, where it lies
    on another device, moved (its weights, constants and the device of every
    tensor it makes). ``fn`` takes one array of exactly
    ``manifest["input_shape"]`` (static shapes; use :class:`ServingModel` for
    ragged batches), and one more of each shape of
    ``manifest["extra_inputs"]`` (a segmentation artifact's categories), and
    returns a numpy array. ``fn.device_call`` is the same forward from tensors
    on the device to a tensor on the device, without the host copies (the
    program's graph called directly, its points' shape checked);
    ``fn.program`` is the loaded ``torch.export.ExportedProgram``, whose
    ``module()`` computes the same with torch's own input guards."""
    device = resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        manifest = json.loads(zf.read(_MANIFEST).decode("utf-8"))
        version = manifest.get("format_version")
        if version != FORMAT_VERSION:
            raise ValueError(
                f"unsupported artifact format {version!r} (expected {FORMAT_VERSION}); "
                "re-export it with this package's cli/export_model.py")
        # refuse an unserved mode, or a seg manifest without its table, before any work
        _check_mode(manifest)
        quantization = manifest.get("quantization", "none")
        if quantization not in QUANTIZATIONS:
            raise ValueError(f"unsupported artifact quantization {quantization!r} "
                             f"(expected one of {list(QUANTIZATIONS)})")
        if device.type not in manifest["platforms"]:
            raise ValueError(
                f"artifact was exported for {manifest['platforms']}, but the device is "
                f"{device.type!r}; re-export with --platforms {device.type}")
        blob = zf.read(_PROGRAM)
    program = torch.export.load(io.BytesIO(blob))  # on the CPU, as export_forward keeps it
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    call = _lifted_call(program)
    shape = tuple(manifest["input_shape"])
    extra_specs = manifest.get("extra_inputs", [])

    def device_call(points: torch.Tensor, *extra: torch.Tensor) -> torch.Tensor:
        if tuple(points.shape) != shape or len(extra) != len(extra_specs):
            raise ValueError(
                f"the program takes points of shape {shape} and {len(extra_specs)} more "
                f"inputs, got {tuple(points.shape)} and {len(extra)}")
        with torch.inference_mode():
            return call(points, *extra)

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
    fn.program = program
    return fn, manifest

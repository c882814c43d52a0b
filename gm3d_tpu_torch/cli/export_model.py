"""Export a model to a self-contained serving artifact (``.gm3dx``).

  # classifier (finetune config + the finetune CLI's best checkpoint)
  python -m gm3d_tpu_torch.cli.export_model --config configs/pointmae/finetune_modelnet.yaml \
      --ckpt experiments/ft/ckpt/best --out model.gm3dx --export_batch 128

  # frozen featurizer (pretrain config + checkpoint, SVM/kNN feature contract);
  # --model_family m2ae pools the Point-M2AE's coarsest tokens
  python -m gm3d_tpu_torch.cli.export_model --config configs/pointmae/config.yaml \
      --ckpt pretrained.pth --mode features --out feats.gm3dx
  python -m gm3d_tpu_torch.cli.export_model --config configs/m2ae/config_Point_M2AE.yaml \
      --ckpt experiments/m2ae/ckpt --mode features --model_family m2ae --out m2ae.gm3dx

  # a Point-M2AE classifier: its finetune config (Point_M2AE_ModelNet40 /
  # Point_M2AE_ScanObjectNN) and the finetune CLI's best checkpoint (its seg
  # model likewise: seg_shapenetpart_PointM2AE.yaml, --mode segmentation)
  python -m gm3d_tpu_torch.cli.export_model \
      --config configs/m2ae/finetune_modelnet_PointM2AE.yaml \
      --ckpt experiments/m2ae_ft/ckpt/best --out m2ae_cls.gm3dx

  # part segmentation (seg config + the seg CLI's best checkpoint): inputs of
  # exactly npoints points and each cloud's category; the manifest carries
  # the category -> parts table the server's arg-max reads
  python -m gm3d_tpu_torch.cli.export_model --config configs/pointmae/seg_shapenetpart.yaml \
      --ckpt experiments/seg/ckpt/best --mode segmentation --out seg.gm3dx --export_batch 16

  # dynamic-int8 (w8a8) weights and products, any mode: a smaller artifact
  python -m gm3d_tpu_torch.cli.export_model --config configs/pointmae/finetune_modelnet.yaml \
      --ckpt experiments/ft/ckpt/best --quantize int8 --out model_int8.gm3dx

  # one artifact that serves on the CPU and on the card (traced on --device)
  python -m gm3d_tpu_torch.cli.export_model --config configs/pointmae/finetune_modelnet.yaml \
      --ckpt experiments/ft/ckpt/best --platforms cpu,cuda --out model.gm3dx

``--ckpt`` takes either of two forms:

  - a checkpoint ROOT written by the port's CLIs (``ckpt/checkpoint.py``):
    the rolling ``.../ckpt``, whose latest step is read, or a pinned
    subdirectory such as the finetune CLI's ``.../ckpt/best``. Its ``model``
    is loaded and its step goes into the manifest's ``ckpt_step``, as the JAX
    export does;
  - a torch ``.pth`` state dict under the reference's parameter names (what
    the JAX package's ``export_torch_checkpoint`` in
    ``gm3d_tpu/ckpt/torch_import.py`` writes and
    :func:`gm3d_tpu_torch.ckpt.state_dict_from_flax` returns).

Either loads with ``strict=True``. A bad path raises ``FileNotFoundError``;
without ``--ckpt`` the export warns and carries weights drawn from ``--seed``
(smoke/test use only). The forward is traced on ``--device`` into a
``torch.export`` program (``serve/export.py``); the artifact is loadable
without this package's model code and serves on each of ``--platforms``.
Serve it with ``gm3d_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional, Sequence

import torch

from gm3d_tpu_torch.ckpt import load_torch_file
from gm3d_tpu_torch.ckpt.checkpoint import restore_raw
from gm3d_tpu_torch.cli.common import base_parser, compute_dtype, load_config
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.data.datasets import SEG_CLASSES
from gm3d_tpu_torch.ops.fps import MAX_POINTS as FPS_MAX_POINTS
from gm3d_tpu_torch.serve.export import (
    build_classifier_fn,
    build_feature_fn,
    build_seg_fn,
    check_platforms,
    export_forward,
    save_artifact,
)
from gm3d_tpu_torch.serve.quantize import quantize_module
from gm3d_tpu_torch.utils import get_logger
from gm3d_tpu_torch.utils.device import dtype_name, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("export a serving artifact")
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint root of the port's CLIs (.../ckpt, .../ckpt/best) "
                        "or a torch .pth state dict in the reference's names")
    p.add_argument("--out", required=True, help="output .gm3dx path")
    p.add_argument("--mode", choices=["classifier", "features", "segmentation"],
                   default="classifier")
    p.add_argument("--model_family", choices=["gm3d", "pointmae", "m2ae"], default="gm3d",
                   help="pretrain family for --mode features")
    p.add_argument("--export_batch", type=int, default=128,
                   help="static batch of the artifact (requests are "
                        "padded/chunked onto it by ServingModel)")
    p.add_argument("--input_points", type=int, default=None,
                   help="points per input cloud (default: the config's "
                        "npoints; FPS to npoints runs inside the forward "
                        "when larger; a segmentation export takes npoints only)")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="dynamic-int8 w8a8 weights and products of every dense layer "
                        "(serve/quantize.py); the fused kernels are not on the serving path")
    p.add_argument("--platforms", default=None,
                   help="comma list out of cpu, cuda: the devices the artifact serves on "
                        "(default: --device's type); the forward is traced on --device")
    return p.parse_args(argv)


def _model_cfg(args, cfg) -> tuple[str, dict]:
    """(manifest name, ``model`` section) of the model the artifact carries."""
    if args.mode == "features" and args.model_family == "gm3d":
        # the student's hyperparameters are the reference's hard-coded class
        # values, whatever the config's model section says
        return "GM3DStudent", {"NAME": "GM3D_Student"}
    name = cfg["model"]["NAME"]
    want = {"classifier": "PointTransformer", "segmentation": "PointTransformerSeg",
            "features": "Point_M2AE" if args.model_family == "m2ae" else "Point_MAE"}[args.mode]
    if (args.mode == "classifier" and name in ("Point_M2AE_ModelNet40",
                                               "Point_M2AE_ScanObjectNN")
            or args.mode == "segmentation" and name == "Point_M2AE_SEG"):
        want = name
    if name != want:
        raise ValueError(
            f"--mode {args.mode} (--model_family {args.model_family}) exports a "
            f"{want} config, got model {cfg['model']['NAME']!r}")
    return want, dict(cfg["model"])


def check_input_points(n_input: int, npoints: int, device: torch.device) -> None:
    """Refuses, at export time, an input larger than the FPS kernel takes
    where the forward would run it on the card (``device``: a platform the
    artifact serves on)."""
    if device.type == "cuda" and n_input > npoints and n_input > FPS_MAX_POINTS:
        raise ValueError(
            f"--input_points {n_input}: the forward's FPS to {npoints} points runs "
            f"on the card, whose kernel takes at most {FPS_MAX_POINTS} points a cloud")


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args)
    logger = get_logger("gm3d.export")
    dtype = compute_dtype(args)
    npoints = cfg.get("npoints", 1024)
    n_input = args.input_points or npoints
    if args.mode == "segmentation" and n_input != npoints:
        # seg outputs are PER POINT: an FPS in the forward would label another
        # cloud than the caller sent (serve/export.py::build_seg_fn)
        raise ValueError(
            f"--mode segmentation requires --input_points == npoints ({npoints}); "
            f"got {n_input}")
    platforms = check_platforms(args.platforms.split(",") if args.platforms is not None
                                else (device.type,))
    for platform in platforms:
        check_input_points(n_input, npoints, torch.device(platform))

    model_name, model_cfg = _model_cfg(args, cfg)
    model = build_model_from_cfg(model_cfg, dtype=dtype)
    step = -1
    if args.ckpt and os.path.isdir(args.ckpt):
        raw = restore_raw(args.ckpt)
        if raw is None:
            raise FileNotFoundError(f"no checkpoint at {args.ckpt}")
        model.load_state_dict(raw["model"], strict=True)
        step = int(raw["step"])
        logger.info(f"restored ckpt step {step} from {args.ckpt}")
    elif args.ckpt:
        if not os.path.isfile(args.ckpt):
            raise FileNotFoundError(f"no checkpoint at {args.ckpt}")
        model.load_state_dict(load_torch_file(args.ckpt), strict=True)
        logger.info(f"loaded weights from {args.ckpt}")
    else:
        logger.warning(f"no --ckpt: exporting RANDOM weights (seed {args.seed})")
        model.reset_parameters(torch.Generator().manual_seed(args.seed))
    # the int8 layout on a copy: the traced program holds its int8 weights
    traced = quantize_module(copy.deepcopy(model)) if args.quantize == "int8" else model
    traced.to(device).eval()

    manifest = {
        "mode": args.mode,
        "model": model_name,
        "model_cfg": model_cfg,
        "npoints": npoints,
        "ckpt_step": step,
        "compute_dtype": dtype_name(dtype),
        "quantization": args.quantize or "none",
    }
    points = torch.zeros((args.export_batch, n_input, 3), dtype=torch.float32, device=device)
    if args.mode == "segmentation":
        fn = build_seg_fn(traced)
        example = (points, torch.zeros((args.export_batch,), dtype=torch.int32, device=device))
        # the category -> parts table, so that the server serves the
        # category-restricted arg-max without this package's tables
        manifest["seg_classes"] = {k: list(v) for k, v in SEG_CLASSES.items()}
        manifest["cls_names"] = sorted(SEG_CLASSES)
    elif args.mode == "classifier":
        fn, example = build_classifier_fn(traced, npoints), points
    else:
        fn, example = build_feature_fn(traced, npoints), points
    t0 = time.perf_counter()
    exported = export_forward(fn, example, platforms, quantize=args.quantize)
    t1 = time.perf_counter()
    path = save_artifact(args.out, exported, manifest)
    logger.info(f"exported {args.mode} ({model_name}) -> {path} "
                f"platforms={list(exported.platforms)} "
                f"quantization={args.quantize or 'none'} "
                f"(traced in {t1 - t0:.2f} s, saved in {time.perf_counter() - t1:.2f} s)")
    return path


if __name__ == "__main__":
    main()

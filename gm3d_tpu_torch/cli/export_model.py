"""Export a model to a self-contained serving artifact (``.gm3dx``).

  # classifier (finetune config + the finetune CLI's best checkpoint)
  python -m gm3d_tpu_torch.cli.export_model --config configs/pointmae/finetune_modelnet.yaml \
      --ckpt experiments/ft/ckpt/best --out model.gm3dx --export_batch 128

  # frozen featurizer (pretrain config + checkpoint, SVM/kNN feature contract)
  python -m gm3d_tpu_torch.cli.export_model --config configs/pointmae/config.yaml \
      --ckpt pretrained.pth --mode features --out feats.gm3dx

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
(smoke/test use only). Serve the artifact with ``gm3d_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from gm3d_tpu_torch.ckpt import load_torch_file
from gm3d_tpu_torch.ckpt.checkpoint import restore_raw
from gm3d_tpu_torch.cli.common import base_parser, compute_dtype, load_config
from gm3d_tpu_torch.config import build_model_from_cfg
from gm3d_tpu_torch.ops.fps import MAX_POINTS as FPS_MAX_POINTS
from gm3d_tpu_torch.serve.export import save_artifact
from gm3d_tpu_torch.utils import get_logger
from gm3d_tpu_torch.utils.device import dtype_name, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None):
    p = base_parser("export a serving artifact")
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint root of the port's CLIs (.../ckpt, .../ckpt/best) "
                        "or a torch .pth state dict in the reference's names")
    p.add_argument("--out", required=True, help="output .gm3dx path")
    p.add_argument("--mode", choices=["classifier", "features"], default="classifier")
    p.add_argument("--model_family", choices=["gm3d", "pointmae"], default="gm3d",
                   help="pretrain family for --mode features")
    p.add_argument("--export_batch", type=int, default=128,
                   help="static batch of the artifact (requests are "
                        "padded/chunked onto it by ServingModel)")
    p.add_argument("--input_points", type=int, default=None,
                   help="points per input cloud (default: the config's "
                        "npoints; FPS to npoints runs inside the forward "
                        "when larger)")
    return p.parse_args(argv)


def _model_cfg(args, cfg) -> tuple[str, dict]:
    """(manifest name, ``model`` section) of the model the artifact carries."""
    if args.mode == "features" and args.model_family == "gm3d":
        # the student's hyperparameters are the reference's hard-coded class
        # values, whatever the config's model section says
        return "GM3DStudent", {"NAME": "GM3D_Student"}
    want = "PointTransformer" if args.mode == "classifier" else "Point_MAE"
    if cfg["model"]["NAME"] != want:
        raise ValueError(
            f"--mode {args.mode} (--model_family {args.model_family}) exports a "
            f"{want} config, got model {cfg['model']['NAME']!r}")
    return want, dict(cfg["model"])


def check_input_points(n_input: int, npoints: int, device: torch.device) -> None:
    """Refuses, at export time, an input larger than the FPS kernel takes
    where the forward would run it on the card."""
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
    check_input_points(n_input, npoints, device)

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

    manifest = {
        "mode": args.mode,
        "model": model_name,
        "model_cfg": model_cfg,
        "npoints": npoints,
        "ckpt_step": step,
        "compute_dtype": dtype_name(dtype),
        "quantization": "none",
    }
    path = save_artifact(args.out, model, manifest,
                         (args.export_batch, n_input, 3), device)
    logger.info(f"exported {args.mode} ({model_name}) -> {path} "
                f"platforms={[device.type]}")
    return path


if __name__ == "__main__":
    main()

"""Shared CLI plumbing of the port."""

from __future__ import annotations

import argparse

import torch

from gm3d_tpu_torch.config import cfg_from_yaml_file


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="device to run on (default: cuda, which fails when "
                        "there is no GPU; pass cpu to run on the CPU on purpose)")


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", required=True, help="YAML config (configs/...)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", help="bf16 compute dtype")
    add_device_arg(p)
    return p


def load_config(args):
    return cfg_from_yaml_file(args.config)


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.bf16 else torch.float32

"""Infra utilities of the port."""

from gm3d_tpu_torch.utils.logging import get_logger

__all__ = ["get_logger"]

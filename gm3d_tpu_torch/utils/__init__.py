"""Infra utilities of the port: logging, windowed meters, JSON-lines epoch
logs, the deferred metrics pipeline and the NaN-loss exit."""

from gm3d_tpu_torch.utils.logging import JsonlLogger, ScalarWriter, get_logger, print_log
from gm3d_tpu_torch.utils.meters import AverageMeter, MetricLogger, SmoothedValue

__all__ = [
    "get_logger",
    "print_log",
    "JsonlLogger",
    "ScalarWriter",
    "SmoothedValue",
    "MetricLogger",
    "AverageMeter",
]

"""Named loggers, JSON-lines epoch records and TensorBoard scalars.

Port of ``gm3d_tpu/utils/logging.py``: ``get_logger``, ``print_log``,
``ScalarWriter`` and ``JsonlLogger``. The port runs one process, so the
process index of the JAX module is always 0 here and every writer is on."""

from __future__ import annotations

import json
import logging
import os
from typing import Optional


def get_logger(name: str = "gm3d", log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_gm3d_configured", False):
        return logger
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.setLevel(level)
    logger._gm3d_configured = True  # type: ignore[attr-defined]
    return logger


def print_log(msg: str, logger: Optional[logging.Logger | str] = None,
              level: int = logging.INFO) -> None:
    if logger is None:
        print(msg)
    elif isinstance(logger, str):
        get_logger(logger).log(level, msg)
    else:
        logger.log(level, msg)


class ScalarWriter:
    """TensorBoard scalar writer (reference SummaryWriter usage,
    ``main_pretrain.py:272,281-286``); silently no-ops where
    ``torch.utils.tensorboard`` cannot be imported."""

    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._writer = SummaryWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class JsonlLogger:
    """Per-epoch JSON-lines stats file ({model}_{exp}_log.txt format)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

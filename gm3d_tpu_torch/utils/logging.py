"""Named loggers, JSON-lines epoch records and TensorBoard scalars.

Port of ``gm3d_tpu/utils/logging.py``: ``get_logger``, ``print_log``,
``ScalarWriter`` and ``JsonlLogger``, rank-aware as the JAX module is: under
data parallelism (``parallel/``) only rank 0 writes the log file, the
TensorBoard scalars and the JSON-lines records, and the other ranks' loggers
surface errors only."""

from __future__ import annotations

import json
import logging
import os
from typing import Optional


def _is_main() -> bool:
    from gm3d_tpu_torch.parallel.multihost import is_main_process

    return is_main_process()


def get_logger(name: str = "gm3d", log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_gm3d_configured", False):
        return logger
    main = _is_main()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and main:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    # the other ranks only surface errors (the reference's behaviour)
    logger.setLevel(level if main else logging.ERROR)
    logger._gm3d_configured = True  # type: ignore[attr-defined]
    return logger


def print_log(msg: str, logger: Optional[logging.Logger | str] = None,
              level: int = logging.INFO) -> None:
    if logger is None:
        if _is_main():
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
        if log_dir and _is_main():
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
        self.enabled = _is_main()
        if self.enabled:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, record: dict) -> None:
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

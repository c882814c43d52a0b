"""Named loggers with one stream handler and an optional file handler.

Port of ``gm3d_tpu/utils/logging.py::get_logger``."""

from __future__ import annotations

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

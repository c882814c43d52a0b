"""Numerical-safety tooling: the NaN-loss hard exit of the reference
(``engine_pretrain_Classifier_SVM.py:232-234``).

Own copy of ``gm3d_tpu/utils/debug.py::check_finite_loss``."""

from __future__ import annotations

import math
import sys


def check_finite_loss(loss_value: float, logger=None, exit_on_nan: bool = True) -> bool:
    """Reference behaviour: non-finite loss aborts the run
    (``engine_pretrain_Classifier_SVM.py:217-219,232-234``)."""
    if math.isfinite(loss_value):
        return True
    msg = f"Loss is {loss_value}, stopping"
    if logger is not None:
        logger.error(msg)
    else:
        print(msg, file=sys.stderr)
    if exit_on_nan:
        sys.exit(1)
    return False

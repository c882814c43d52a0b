"""Classification accuracy.

Own copy of ``gm3d_tpu/eval/metrics.py::accuracy`` (numpy). ``part_miou``,
the segmentation metric of that file, comes with segmentation
(``ROADMAP.md`` Queue 1 item 5).
"""

from __future__ import annotations

import numpy as np


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """The share of rows whose arg-max is the label."""
    return float((np.asarray(logits).argmax(-1) == np.asarray(labels)).mean())

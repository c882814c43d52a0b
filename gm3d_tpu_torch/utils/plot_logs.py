"""Accuracy-curve extraction + comparison plot.

Own copy of ``gm3d_tpu/utils/plot_logs.py`` (reference ``plot_logs.py``,
re-targeted at the JSON-lines epoch logs the CLIs write; matplotlib with the
Agg backend)."""

from __future__ import annotations

import json
import re
from typing import Dict, List, Tuple


def extract_series(path: str, key: str = "val_svm_acc") -> Tuple[List[int], List[float]]:
    """Read (epoch, value) pairs for ``key`` from a JSONL log; also accepts
    reference-style text logs via a regex fallback (``plot_logs.py:13-50``)."""
    epochs, values = [], []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                if key in rec:
                    epochs.append(int(rec.get("epoch", i)))
                    values.append(float(rec[key]))
                continue
            except json.JSONDecodeError:
                pass
            m = re.search(rf"{re.escape(key)}\s*[:=]\s*([0-9.]+)", line)
            if m:
                epochs.append(len(epochs))
                values.append(float(m.group(1)))
    return epochs, values


def plot_comparison(
    logs: Dict[str, str], out_path: str, key: str = "val_svm_acc"
) -> None:
    """Plot several runs' curves into one PNG (label -> log path)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for label, path in logs.items():
        epochs, values = extract_series(path, key)
        if epochs:
            ax.plot(epochs, values, label=label)
    ax.set_xlabel("epoch")
    ax.set_ylabel(key)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)

"""Few-shot fold generator (reference ``datasets/generate_few_shot_data.py:20-76``).

Own copy of ``gm3d_tpu/data/fewshot_gen.py`` (numpy and Python only): builds
``folds`` x {way}-way {shot}-shot episodes from a labelled dataset and
pickles them as ``{way}way_{shot}shot/{fold}.pkl``, with at most 20 test
samples a class, the published ModelNet40 few-shot protocol. The same seed
gives the same episodes, byte for byte, as the JAX package's generator.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np


def generate_few_shot_folds(
    points: np.ndarray,
    labels: np.ndarray,
    test_points: np.ndarray,
    test_labels: np.ndarray,
    out_dir: str,
    ways: Sequence[int] = (5, 10),
    shots: Sequence[int] = (10, 20),
    folds: int = 10,
    test_per_class: int = 20,
    seed: int = 0,
):
    """Write the folds under ``out_dir``. Each fold picks ``way`` classes,
    relabels them 0 .. way - 1 in the order drawn, and takes ``shot``
    training and up to ``test_per_class`` test clouds of each; an item is
    ``(points, new_label, original_label)``."""
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    for way in ways:
        for shot in shots:
            d = os.path.join(out_dir, f"{way}way_{shot}shot")
            os.makedirs(d, exist_ok=True)
            for fold in range(folds):
                classes = rng.choice(num_classes, way, replace=False)
                train_items, test_items = [], []
                for new_label, cls in enumerate(classes):
                    tr_idx = np.where(labels == cls)[0]
                    te_idx = np.where(test_labels == cls)[0]
                    tr_pick = rng.choice(tr_idx, shot, replace=False)
                    te_pick = rng.choice(
                        te_idx, min(test_per_class, len(te_idx)), replace=False
                    )
                    for i in tr_pick:
                        train_items.append((points[i], new_label, int(cls)))
                    for i in te_pick:
                        test_items.append((test_points[i], new_label, int(cls)))
                with open(os.path.join(d, f"{fold}.pkl"), "wb") as f:
                    pickle.dump({"train": train_items, "test": test_items}, f)

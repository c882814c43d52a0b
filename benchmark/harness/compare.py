"""The numbers that decide ``correct``: the program's readings against the
plain reference's, each a gap to be held under its limit.

Training, over the three checked steps:

  - ``loss_gap``: the largest of |loss - loss_ref| / |loss_ref| over the steps;
  - ``grad_gap``: the first step's gradient as the optimizer took it, leaf by
    leaf: the gap between the two norms over the larger of the reference
    leaf's norm and the median leaf's; the worst leaf;
  - ``change_gap``: the same for each parameter's change over the three
    steps. Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out: AdamW moves them by round-off alone;
  - ``ema_change_gap``: the same for each EMA parameter's change over the
    steps (the change worked out in float64), over the same leaves.

Serving, over the sampled answers: ``logit_gap``, the largest gap of a served
logit from the reference's over the larger of that cloud's largest reference
logit and the median cloud's.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping

import torch

NEGLIGIBLE_GRAD = 1e-3


def _finite(x: float) -> float:
    """A gap that is not a number (a NaN in the program) counts as infinite."""
    return x if math.isfinite(x) else math.inf


def _leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float],
              keep=lambda name: True) -> float:
    names = [n for n in ref if keep(n)]
    if set(names) - set(prog):
        return float("inf")  # a leaf the program never moved or never took
    floor = statistics.median(ref[n] for n in names)
    return max(_finite(abs(prog[n] - ref[n]) / max(ref[n], floor)) for n in names)


def norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t)) for n, t in tensors.items()}


def training(readings: Dict, reference: Dict) -> Dict[str, float]:
    ref_losses = [float(x) for x in reference["losses"]]
    loss_gap = max(_finite(abs(p - r) / abs(r)) for p, r in zip(readings["losses"], ref_losses))
    ref_grads = norms(reference["first_grads"])
    ref_change = norms(reference["change"])
    ref_ema = norms(reference["ema_change"])
    floor = statistics.median(ref_grads.values())
    moved = {n for n, v in ref_grads.items() if v >= NEGLIGIBLE_GRAD * floor}
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(readings["first_grad_norms"], ref_grads),
            "change_gap": _leaf_gap(readings["change_norms"], ref_change, lambda n: n in moved),
            "ema_change_gap": _leaf_gap(readings["ema_change_norms"], ref_ema,
                                        lambda n: n in moved)}


def serving(served: torch.Tensor, ref: torch.Tensor) -> float:
    """``logit_gap`` of served logits (N, C) against the reference's."""
    scale = ref.abs().amax(dim=1)
    floor = scale.median()
    gap = (served - ref).abs().amax(dim=1) / torch.maximum(scale, floor)
    return _finite(float(gap.max()))

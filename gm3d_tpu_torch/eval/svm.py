"""Linear-SVM probe: the pretrain quality gate.

Port of ``gm3d_tpu/eval/svm.py``. Features are pooled encoder outputs
(``feature.mean(1) + feature.max(1)``, ``main_pretrain.py:713-715``) of every
cloud of two labelled loaders; a linear ``C = 0.01`` SVC is fitted on the
first and scored on the second. The JAX package fits sklearn's ``SVC`` on the
host; here the fit is the port's own (``eval/linear_svc.py``), in float64 on
the device where the features lie, so the features never leave the card.

The encoder's grouping launches the FPS and KNN kernels (Point-M2AE's
hierarchy three of each). As in the JAX
probe, the encoder runs outside ``fused_attention_scope`` and its patch embed
as the module does, in eval mode, without gradient.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, Tuple

import torch
from torch import nn

from gm3d_tpu_torch.eval.linear_svc import TOL, fit_linear_svc, predict
from gm3d_tpu_torch.ops.fps import fps
from gm3d_tpu_torch.parallel.multihost import gather_features

SVM_C = 0.01


def make_feature_fn(model: nn.Module, npoints: int = 1024,
                    batch_floor: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """``points (B, N, 3) -> pooled features (B, D)``: FPS down to ``npoints``
    only where a cloud has more, then, in eval mode without gradient (the
    model's train / eval mode is put back after), the model's own pooling
    where it has one (``pooled_features``: Point-M2AE, ``mean + max`` a scale,
    concatenated), else ``mean + max`` over ``model.encode_features``.
    ``batch_floor`` is accepted and does nothing: the JAX package tiles small
    batches up to it to work around a TPU compiler bug."""
    del batch_floor
    pooled = getattr(model, "pooled_features", None)

    @torch.no_grad()
    def feature_fn(pts: torch.Tensor) -> torch.Tensor:
        x = fps(pts, npoints) if pts.shape[1] > npoints else pts
        training = model.training
        model.eval()
        try:
            if pooled is not None:
                return pooled(x)
            tok = model.encode_features(x)
        finally:
            model.train(training)
        return tok.mean(dim=1) + tok.max(dim=1).values

    return feature_fn


def extract_features(feature_fn: Callable[[torch.Tensor], torch.Tensor], loader: Iterable,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pooled float32 features (N, D) and int64 labels (N,) of a labelled
    loader, both on ``device``. Every batch is enqueued before anything is
    read back: nothing here waits for the device."""
    feats, labels = [], []
    for pts, lbl in loader:
        feats.append(feature_fn(torch.as_tensor(pts).to(device)).to(torch.float32))
        labels.append(torch.as_tensor(lbl).to(device=device, dtype=torch.int64))
    return torch.cat(feats), torch.cat(labels)


def evaluate_svm(train_features: torch.Tensor, train_labels: torch.Tensor,
                 test_features: torch.Tensor, test_labels: torch.Tensor,
                 stats: Optional[dict] = None) -> float:
    """``main_pretrain.py:710-717`` (features already pooled): the accuracy
    of a linear ``C = 0.01`` SVC, as a fraction. ``stats``, where given,
    gets the solver's ``iterations`` (the most any pair of classes took) and,
    where a pair stopped above the solver's tolerance (its iteration cap),
    ``gap``, the largest pair's KKT gap."""
    model = fit_linear_svc(train_features, train_labels, c=SVM_C)
    pred = predict(model, test_features)
    if stats is not None:
        stats["iterations"] = int(model.iterations.max())
        gap = float(model.gap.max())
        if not gap < TOL:
            stats["gap"] = gap
    return float((pred == test_labels.to(pred.device)).sum()) / pred.shape[0]


def svm_probe(model: nn.Module, train_loader: Iterable, test_loader: Iterable,
              npoints: int = 1024, batch_floor: int = 0, stats: Optional[dict] = None) -> float:
    """The whole probe on ``model``'s device: features of both loaders
    (gathered over ranks under data parallelism), the fit, the accuracy. ``stats``, where given, gets the wall times of the
    feature extraction and of the fit in ms (``extract_ms``, ``fit_ms``) and
    the solver's ``iterations``."""
    device = next(model.parameters()).device
    feature_fn = make_feature_fn(model, npoints, batch_floor)
    sync = (torch.cuda.current_stream(device).synchronize if device.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    # under data parallelism each loader holds this rank's block of its set
    # (cli/common.py::rank_block_loader): every rank fits the whole set
    tr_f, tr_l = gather_features(*extract_features(feature_fn, train_loader, device))
    te_f, te_l = gather_features(*extract_features(feature_fn, test_loader, device))
    sync()
    t1 = time.perf_counter()
    acc = evaluate_svm(tr_f, tr_l, te_f, te_l, stats)
    if stats is not None:
        stats.update(extract_ms=(t1 - t0) * 1e3, fit_ms=(time.perf_counter() - t1) * 1e3)
    return acc

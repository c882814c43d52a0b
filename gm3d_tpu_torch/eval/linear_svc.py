"""A linear C-SVC in PyTorch: what ``sklearn.svm.SVC(C=0.01, kernel='linear')``
fits and predicts, without sklearn.

The JAX package's SVM probe fits sklearn's ``SVC`` (libsvm) on the host. The
port keeps no such dependency: this module solves the same problems with
batched tensor operations, in float64, on the device where the features lie.

* One-vs-one: one binary problem per pair of classes ``(i, j)``, ``i < j``,
  classes in sorted order (libsvm's order as sklearn calls it).
* libsvm's dual per pair: minimise ``1/2 a^T Q a - e^T a`` subject to
  ``0 <= a <= C`` and ``y^T a = 0``, with ``Q_kl = y_k y_l x_k . x_l`` and
  ``y = +1`` for class ``i``. The bias is not regularised: ``rho`` is the
  mean of ``y_k G_k`` over the free ``a_k`` (``0 < a_k < C``) and, when no
  ``a_k`` is free, the midpoint of the bounds the others set
  (libsvm's ``Solver::calculate_rho``). The decision value is
  ``w . x - rho``; a positive one votes for class ``i``, any other for ``j``.
* Prediction: the class with the most votes, the first one on a tie
  (libsvm's ``svm_predict_values``).

The solver is libsvm's SMO with its second-order working-set choice
(``Solver::select_working_set``) and its two-variable update, every pair
stepping at once: each iteration picks ``(i, j)`` in every pair that has not
converged and updates those two multipliers and the pair's gradient. A pair
stops when its KKT gap ``max_{I_up} -y G + max_{I_low} y G`` falls below
``TOL``, a hundredth of libsvm's default ``1e-3``, so the solution sits
nearer the optimum than sklearn's. A pair that has not converged within
``max_iter`` iterations raises; no half-solved model is returned.

Memory: one Gram matrix of all training features (N^2 float64; 0.78 GB at
ModelNet40's 9,843 clouds); each iteration gathers the two rows it needs of
every pair from it. The pairs are padded to the largest pair's size, and
the batch shrinks to the pairs still running as the others converge.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# the KKT gap at which a pair stops (libsvm's default is 1e-3)
TOL = 1e-5
MAX_ITER = 200_000
# iterations between two reads of the pairs' progress (each read waits for the device)
CHECK_EVERY = 32
# libsvm's TAU: the curvature used where K_ii + K_jj - 2 K_ij is not positive
TAU = 1e-12


@dataclass
class LinearSVCModel:
    """A fitted one-vs-one linear C-SVC. ``coef`` (P, D) and ``intercept``
    (P,) hold ``w`` and ``-rho`` of each pair, in pair order; ``iterations``
    (P,) the SMO iterations each pair took; ``gap`` (P,) its final KKT gap."""

    classes: torch.Tensor
    coef: torch.Tensor
    intercept: torch.Tensor
    iterations: torch.Tensor
    gap: torch.Tensor

    @property
    def pairs(self) -> list[tuple[int, int]]:
        k = len(self.classes)
        return [(i, j) for i in range(k) for j in range(i + 1, k)]


def _pair_layout(codes: torch.Tensor, num_classes: int):
    """Per pair: the training rows of its two classes in data order, padded to
    the largest pair (``idx`` (P, n) int64, ``valid`` (P, n) bool) and their
    labels (``y`` (P, n) float64, +1 for the pair's first class)."""
    dev = codes.device
    members = [torch.nonzero(codes == c).flatten() for c in range(num_classes)]
    pairs = [(i, j) for i in range(num_classes) for j in range(i + 1, num_classes)]
    width = max(len(members[i]) + len(members[j]) for i, j in pairs)
    idx = torch.zeros((len(pairs), width), dtype=torch.int64, device=dev)
    y = torch.zeros((len(pairs), width), dtype=torch.float64, device=dev)
    valid = torch.zeros((len(pairs), width), dtype=torch.bool, device=dev)
    for p, (i, j) in enumerate(pairs):
        rows = torch.sort(torch.cat([members[i], members[j]])).values
        n = len(rows)
        idx[p, :n] = rows
        y[p, :n] = torch.where(codes[rows] == i, 1.0, -1.0).to(torch.float64)
        valid[p, :n] = True
    return idx, y, valid


def _smo(gram: torch.Tensor, idx: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
         c: float, max_iter: int):
    """Batched SMO over the pairs. Returns ``(alpha, grad, iterations, gap)``.

    Every ``CHECK_EVERY`` iterations the pairs that have converged leave the
    batch (their results are written back) and the batch is cut to the widest
    pair left, so the long tail of slow pairs runs alone."""
    num_pairs, _ = idx.shape
    dev = gram.device
    alpha = torch.zeros_like(y)
    grad = torch.where(valid, -1.0, 0.0).to(torch.float64)  # G = Q a - e at a = 0
    iterations = torch.zeros(num_pairs, dtype=torch.int64, device=dev)
    gap = torch.full((num_pairs,), float("inf"), dtype=torch.float64, device=dev)
    sizes = valid.sum(dim=1)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float64, device=dev)
    pos_inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    # the batch: the pairs still running, cut to the widest of them
    act = torch.arange(num_pairs, device=dev)
    b_idx, b_y, b_valid, b_alpha, b_grad = idx, y, valid, alpha.clone(), grad.clone()
    b_iters, b_gap = iterations.clone(), gap.clone()
    b_diag = gram[b_idx, b_idx]
    running = torch.ones(num_pairs, dtype=torch.bool, device=dev)
    for it in range(max_iter + 1):
        if it % CHECK_EVERY == 0 or it == max_iter:
            width = b_alpha.shape[1]
            alpha[act, :width], grad[act, :width] = b_alpha, b_grad
            iterations[act], gap[act] = b_iters, b_gap
            keep = torch.nonzero(running).flatten()
            if len(keep) == 0:
                break
            if it == max_iter:
                left = act[keep].tolist()
                raise RuntimeError(
                    f"linear SVC: {len(left)} of {num_pairs} pairs did not reach a KKT gap "
                    f"below {TOL:g} within {max_iter} SMO iterations (pairs {left[:5]})")
            if len(keep) < len(act):
                act = act[keep]
                width = int(sizes[act].max())
                b_idx, b_y, b_valid = idx[act, :width], y[act, :width], valid[act, :width]
                b_alpha, b_grad = alpha[act, :width], grad[act, :width]
                b_iters, b_gap, running = iterations[act], gap[act], running[keep]
                b_diag = gram[b_idx, b_idx]
            rows = torch.arange(len(act), device=dev)
            pos = b_y > 0
        below_c, above_0 = b_alpha < c, b_alpha > 0
        up = b_valid & torch.where(pos, below_c, above_0)
        low = b_valid & torch.where(pos, above_0, below_c)
        y_grad = b_y * b_grad
        # i: the steepest violator in I_up
        g_max, i = torch.where(up, -y_grad, neg_inf).max(dim=1)
        g_max2 = torch.where(low, y_grad, neg_inf).max(dim=1).values
        k_i = gram[b_idx[rows, i].unsqueeze(1), b_idx]  # row i of the pair's kernel
        # j: the largest second-order decrease of the objective in I_low
        grad_diff = g_max.unsqueeze(1) + y_grad
        curv = b_diag[rows, i].unsqueeze(1) + b_diag - 2.0 * k_i
        curv = torch.where(curv > 0, curv, TAU)
        obj = torch.where(low & (grad_diff > 0), -grad_diff * grad_diff / curv, pos_inf)
        obj_min, j = obj.min(dim=1)
        b_gap = torch.where(running, g_max + g_max2, b_gap)
        running = running & (b_gap >= TOL) & torch.isfinite(obj_min)
        b_iters += running

        k_j = gram[b_idx[rows, j].unsqueeze(1), b_idx]
        y_i, y_j = b_y[rows, i], b_y[rows, j]
        a_i, a_j = b_alpha[rows, i], b_alpha[rows, j]
        g_i, g_j = b_grad[rows, i], b_grad[rows, j]
        quad = b_diag[rows, i] + b_diag[rows, j] - 2.0 * k_i[rows, j]
        quad = torch.where(quad > 0, quad, TAU)
        # libsvm's two-variable update, both sign cases, clipped to the box
        opposite = y_i != y_j
        # y_i != y_j: a_i - a_j is kept
        delta = (-g_i - g_j) / quad
        diff = a_i - a_j
        oi, oj = a_i + delta, a_j + delta
        fix = (diff > 0) & (oj < 0)
        oi, oj = torch.where(fix, diff, oi), torch.where(fix, 0.0, oj)
        fix = (diff <= 0) & (oi < 0)
        oi, oj = torch.where(fix, 0.0, oi), torch.where(fix, -diff, oj)
        fix = (diff > 0) & (oi > c)
        oi, oj = torch.where(fix, c, oi), torch.where(fix, c - diff, oj)
        fix = (diff <= 0) & (oj > c)
        oi, oj = torch.where(fix, c + diff, oi), torch.where(fix, c, oj)
        # y_i == y_j: a_i + a_j is kept
        delta = (g_i - g_j) / quad
        total = a_i + a_j
        si, sj = a_i - delta, a_j + delta
        fix = (total > c) & (si > c)
        si, sj = torch.where(fix, c, si), torch.where(fix, total - c, sj)
        fix = (total <= c) & (sj < 0)
        si, sj = torch.where(fix, total, si), torch.where(fix, 0.0, sj)
        fix = (total > c) & (sj > c)
        si, sj = torch.where(fix, total - c, si), torch.where(fix, c, sj)
        fix = (total <= c) & (si < 0)
        si, sj = torch.where(fix, 0.0, si), torch.where(fix, total, sj)
        d_i = torch.where(running, torch.where(opposite, oi, si) - a_i, 0.0)
        d_j = torch.where(running, torch.where(opposite, oj, sj) - a_j, 0.0)
        # i != j: j has grad_diff > 0, which i's own entry never has
        b_alpha[rows, i] = a_i + d_i
        b_alpha[rows, j] = a_j + d_j
        b_grad += b_y * ((y_i * d_i).unsqueeze(1) * k_i + (y_j * d_j).unsqueeze(1) * k_j)
    return alpha, grad, iterations, gap


def _rho(alpha: torch.Tensor, grad: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
         c: float) -> torch.Tensor:
    """libsvm's ``calculate_rho`` for every pair: the mean of ``y G`` over the
    free multipliers, else the midpoint of the bounds the others set."""
    y_grad = y * grad
    upper, lower = alpha >= c, alpha <= 0
    free = valid & ~upper & ~lower
    pos = y > 0
    inf = float("inf")
    # ub from (upper, y=-1) and (lower, y=+1); lb from (upper, y=+1) and (lower, y=-1)
    to_ub = valid & ((upper & ~pos) | (lower & pos))
    to_lb = valid & ((upper & pos) | (lower & ~pos))
    ub = torch.where(to_ub, y_grad, inf).min(dim=1).values
    lb = torch.where(to_lb, y_grad, -inf).max(dim=1).values
    n_free = free.sum(dim=1)
    mean_free = torch.where(free, y_grad, 0.0).sum(dim=1) / n_free.clamp(min=1)
    return torch.where(n_free > 0, mean_free, (ub + lb) / 2)


def fit_linear_svc(features: torch.Tensor, labels: torch.Tensor, c: float = 0.01,
                   max_iter: int = MAX_ITER) -> LinearSVCModel:
    """Fit the one-vs-one linear C-SVC on ``features`` (N, D) and integer
    ``labels`` (N,), in float64 on ``features.device``. Raises if a pair has
    not reached a KKT gap below ``TOL`` within ``max_iter`` iterations."""
    if features.ndim != 2 or labels.shape != features.shape[:1]:
        raise ValueError(f"expected (N, D) features and (N,) labels, got "
                         f"{tuple(features.shape)} and {tuple(labels.shape)}")
    dev = features.device
    x = features.to(torch.float64)
    classes, codes = torch.unique(labels.to(dev), sorted=True, return_inverse=True)
    if len(classes) < 2:
        raise ValueError("the linear SVC needs at least two classes")
    idx, y, valid = _pair_layout(codes, len(classes))
    gram = x @ x.T
    alpha, grad, iterations, gap = _smo(gram, idx, y, valid, c, max_iter)
    del gram
    rho = _rho(alpha, grad, y, valid, c)
    # w of each pair: sum_k a_k y_k x_k, through one (P, N) coefficient matrix
    dual = torch.zeros((idx.shape[0], x.shape[0]), dtype=torch.float64, device=dev)
    dual.scatter_add_(1, idx, torch.where(valid, alpha * y, 0.0))
    return LinearSVCModel(classes=classes, coef=dual @ x, intercept=-rho,
                          iterations=iterations, gap=gap)


def ovo_decision_values(model: LinearSVCModel, features: torch.Tensor) -> torch.Tensor:
    """libsvm's decision values, (N, P): positive votes for the pair's first class."""
    x = features.to(device=model.coef.device, dtype=torch.float64)
    return x @ model.coef.T + model.intercept


def decision_function(model: LinearSVCModel, features: torch.Tensor) -> torch.Tensor:
    """sklearn's ``decision_function`` with ``decision_function_shape='ovo'``:
    the (N, P) values above, and for two classes (N,) with the sign flipped
    (positive for the second class), as sklearn returns them."""
    dec = ovo_decision_values(model, features)
    return -dec[:, 0] if len(model.classes) == 2 else dec


def predict(model: LinearSVCModel, features: torch.Tensor) -> torch.Tensor:
    """The class with the most one-vs-one votes, the first one on a tie."""
    dec = ovo_decision_values(model, features)
    num_classes = len(model.classes)
    first = torch.tensor([i for i, _ in model.pairs], device=dec.device)
    second = torch.tensor([j for _, j in model.pairs], device=dec.device)
    winner = torch.where(dec > 0, first, second)
    votes = torch.zeros((dec.shape[0], num_classes), dtype=torch.int64, device=dec.device)
    votes.scatter_add_(1, winner, torch.ones_like(winner))
    # argmax returns the first maximum: libsvm's tie rule
    return model.classes[votes.argmax(dim=1)]

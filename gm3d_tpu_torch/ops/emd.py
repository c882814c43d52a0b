"""Earth Mover's Distance between equal-size point sets.

Port of ``gm3d_tpu/ops/emd.py`` (plain tensor code there too: no kernel of
its own). Two implementations:

- :func:`emd_loss`: entropy-regularised optimal transport (Sinkhorn), log
  domain, a fixed 50 rounds, differentiable; the ``emd`` reconstruction loss
  (``train/losses.py``).
- :func:`emd_auction`: the auction algorithm (Jacobi bidding, relative
  ``eps``), a hard one-to-one assignment within ``n * eps * max(cost)`` of
  the optimal matching cost.

Both read the same cost as the JAX package: ``chamfer._pairwise_sqdist``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gm3d_tpu_torch.ops.chamfer import _pairwise_sqdist

# the auction reads its termination test (every row assigned: a read on the
# host) once every this many rounds. A round after the last row is assigned
# changes nothing (every bid is -inf), so the owners are those of a test
# after every round, as the JAX while_loop makes it.
AUCTION_CHECK_EVERY = 16


def _neg_log_n(n: int, like: torch.Tensor) -> torch.Tensor:
    """``-log(n)`` computed in fp32, as ``-jnp.log(n)`` is."""
    return -torch.log(torch.tensor(float(n), dtype=torch.float32, device=like.device))


def emd_loss(a: torch.Tensor, b: torch.Tensor, epsilon: float = 0.005,
             iters: int = 50) -> torch.Tensor:
    """Approximate EMD (mean matched squared distance) per leading index.

    a, b: (..., n, 3) with equal cardinality and uniform weights. Returns the
    transport cost (...,) in fp32. The cost is normalised by its per-set max
    before the Sinkhorn rounds, so ``epsilon`` behaves alike at any scale."""
    cost = _pairwise_sqdist(a, b)  # (..., n, n)
    n = cost.shape[-1]
    log_mu = _neg_log_n(n, cost).expand(cost.shape[:-1])
    log_nu = _neg_log_n(n, cost).expand(cost.shape[:-2] + (n,))
    scale = cost.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-9)
    logk = -cost / (scale * epsilon)
    f = torch.zeros_like(log_mu)
    g = torch.zeros_like(log_nu)
    for _ in range(iters):
        f = log_mu - torch.logsumexp(logk + g[..., None, :], dim=-1)
        g = log_nu - torch.logsumexp(logk + f[..., :, None], dim=-2)
    pi = torch.exp(logk + f[..., :, None] + g[..., None, :])
    # pi carries total mass 1, so sum(pi * cost) is the mean matched distance
    return (pi * cost).sum(dim=(-2, -1))


def _first_two_max(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The largest and second-largest values over the last axis and the index
    of the largest, the LOWER index on ties (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): two first-maximum arg-max passes."""
    j1 = torch.argmax(v, dim=-1, keepdim=True)
    v1 = torch.gather(v, -1, j1)
    v2 = v.scatter(-1, j1, float("-inf")).amax(dim=-1, keepdim=True)
    return v1[..., 0], v2[..., 0], j1[..., 0]


def emd_auction_assignment(a: torch.Tensor, b: torch.Tensor, eps: float = 0.005,
                           iters: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Auction assignment between equal-size sets.

    a, b: (..., n, 3). Returns ``(owner, cost)``: ``owner[..., j]`` (int64) is
    the index into ``a`` matched to ``b[..., j, :]``, ``cost`` the pairwise
    squared distances. Jacobi bidding: every unassigned row bids for its best
    object with increment ``v1 - v2 + eps``; each object takes the highest
    bid (the lowest row on ties), displacing its previous owner. Ends when
    every row is assigned (tested every ``AUCTION_CHECK_EVERY`` rounds) or
    after ``iters`` rounds; an object left unowned falls back to its cheapest
    row. ``eps`` is relative to the per-set max cost."""
    cost = _pairwise_sqdist(a, b)  # (..., n, n)
    n = cost.shape[-1]
    if n == 1:  # the only matching
        return torch.zeros(cost.shape[:-2] + (1,), dtype=torch.int64, device=cost.device), cost
    scale = cost.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    w = -cost / scale  # benefit, in [-1, 0]
    batch_shape = cost.shape[:-2]
    prices = torch.zeros(batch_shape + (n,), dtype=torch.float32, device=cost.device)
    owner = torch.full(batch_shape + (n,), -1, dtype=torch.int64, device=cost.device)
    idx = torch.arange(n, device=cost.device)
    neg_inf = torch.tensor(float("-inf"), device=cost.device)

    def assigned_rows(owner):
        # row i is assigned iff some object names it as owner
        return (owner[..., :, None] == idx).any(dim=-2)  # (..., rows)

    done = 0
    while done < iters:
        for _ in range(min(AUCTION_CHECK_EVERY, iters - done)):
            v = w - prices[..., None, :]  # (..., row, obj)
            v1, v2, j_star = _first_two_max(v)
            inc = torch.where(assigned_rows(owner), neg_inf, v1 - v2 + eps)
            # bids (..., row, obj): the row's increment at its chosen object
            bids = torch.where(j_star[..., :, None] == idx, inc[..., :, None], neg_inf)
            win_inc = bids.amax(dim=-2)  # (..., obj)
            win_row = torch.argmax(bids, dim=-2)
            has_bid = torch.isfinite(win_inc)
            prices = torch.where(has_bid, prices + win_inc, prices)
            owner = torch.where(has_bid, win_row, owner)
        done += AUCTION_CHECK_EVERY
        if bool(assigned_rows(owner).all()):
            break
    # the fallback for objects left unowned when the rounds ran out
    cheapest = torch.argmin(cost, dim=-2)  # per object
    return torch.where(owner < 0, cheapest, owner), cost


def emd_auction(a: torch.Tensor, b: torch.Tensor, eps: float = 0.005,
                iters: int = 4096) -> torch.Tensor:
    """Mean matched squared distance under the auction assignment, per
    leading index: the hard (one-to-one) counterpart of :func:`emd_loss`."""
    owner, cost = emd_auction_assignment(a, b, eps, iters)
    matched = torch.gather(cost, -2, owner[..., None, :])[..., 0, :]
    return matched.mean(dim=-1)

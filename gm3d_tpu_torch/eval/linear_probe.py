"""Linear probing on frozen pooled encoder features.

Port of ``gm3d_tpu/eval/linear_probe.py`` (reference ``main_linprob.py``),
the reference-effective recipe:

- head = ``BatchNorm1d(affine=False, eps=1e-6)`` -> ``Linear``, the head's
  weight trunc-normal std 0.01, its bias torch's default uniform;
- plain SGD, momentum 0.9, no weight decay, the rate multiplying the momentum
  buffer (``v = 0.9 v + g; p -= lr v``);
- lr = ``blr * batch / 256``, per-iteration half cosine after
  ``warmup_epochs`` of linear warm-up, ``min_lr`` 0;
- cross-entropy; the best epoch's test accuracy is kept.

Runs on the features' device, in fp32, the epoch order from
``np.random.default_rng(seed)`` as in the JAX package. The head's initial
weights come from a ``torch.Generator`` seeded ``seed`` (the JAX package draws
them with ``jax.random``); ``init`` hands in a head instead, so that a test
can start both packages from one.

``LARS`` is the reference's commented-out MoCo-v3 optimizer
(``util/lars.py:15-44``), kept because the JAX package keeps it; nothing
calls it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


class LARS(torch.optim.Optimizer):
    """MoCo-v3 LARS exactly as ``util/lars.py`` (the JAX ``lars``): for
    parameters of more than one dimension ``dp = g + wd * p`` scaled by
    ``eta * |p| / |dp|`` (1 where either norm is 0); others take the raw
    gradient; then ``mu = momentum * mu + dp`` and ``p -= lr * mu``. ``lr``
    may be a callable of the update count."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 weight_decay: float = 0.0, momentum: float = 0.9, eta: float = 0.001):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, momentum=momentum,
                                      eta=eta))
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr = group["lr"](self.count) if callable(group["lr"]) else group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                dp = p.grad
                if p.ndim > 1:  # not a norm's scale or shift, nor a bias
                    dp = dp + group["weight_decay"] * p
                    pn, un = torch.linalg.norm(p), torch.linalg.norm(dp)
                    one = torch.ones_like(pn)
                    q = torch.where(pn > 0.0, torch.where(un > 0.0, group["eta"] * pn / un, one),
                                    one)
                    dp = dp * q
                state = self.state[p]
                if "mu" not in state:
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"]
                mu.mul_(group["momentum"]).add_(dp)
                p.sub_(lr * mu)
        self.count += 1
        return None


def linprob_lr(it: float, peak_lr: float, warmup_epochs: float, epochs: float,
               min_lr: float = 0.0) -> float:
    """``util/lr_sched.py:11-23`` on a fractional-epoch axis."""
    if it < warmup_epochs:
        return peak_lr * it / warmup_epochs
    return min_lr + (peak_lr - min_lr) * 0.5 * (
        1.0 + np.cos(np.pi * (it - warmup_epochs) / (epochs - warmup_epochs)))


def init_head(dim: int, num_classes: int, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head's initial ``(w (dim, C), b (C,))``: ``trunc_normal_(std=0.01)``
    within two deviations and torch ``Linear``'s default bias
    ``U(-1/sqrt(dim), 1/sqrt(dim))``, from a generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.nn.init.trunc_normal_(torch.empty(dim, num_classes), std=0.01, a=-0.02, b=0.02,
                                    generator=gen)
    bound = 1.0 / np.sqrt(dim)
    b = torch.empty(num_classes).uniform_(-bound, bound, generator=gen)
    return w, b


def linear_probe(train_features, train_labels, test_features, test_labels,
                 num_classes: Optional[int] = None, epochs: int = 90, batch_size: int = 256,
                 base_lr: float = 0.1, warmup_epochs: int = 10, seed: int = 0,
                 init: Optional[Tuple] = None, head: Optional[dict] = None) -> float:
    """The reference-effective linear probe (module docstring). Tensors or
    numpy arrays; runs on the training features' device. Returns the BEST
    epoch's test accuracy (``main_linprob.py:294-295`` ``max_accuracy``).
    ``init``: the head's initial ``(w (dim, C), b (C,))`` in place of
    :func:`init_head`'s. ``head``, where given, receives the final ``w``,
    ``b`` and the BatchNorm's ``running_mean`` and ``running_var``."""
    xs = torch.as_tensor(train_features)
    dev = xs.device
    xs = xs.to(torch.float32)
    ys = torch.as_tensor(train_labels, device=dev).to(torch.int64)
    xs_te = torch.as_tensor(test_features, device=dev).to(torch.float32)
    ys_te = torch.as_tensor(test_labels, device=dev).to(torch.int64)
    if num_classes is None:
        num_classes = int(ys.max()) + 1
    dim, num_train = xs.shape[1], xs.shape[0]
    batch_size = min(batch_size, num_train)
    steps_per_epoch = max(num_train // batch_size, 1)
    peak_lr = base_lr * batch_size / 256.0
    # torch BatchNorm1d defaults: momentum 0.1 running-stat EMA, biased batch
    # variance in the normaliser, unbiased in the running statistics
    bn_momentum, bn_eps = 0.1, 1e-6

    def param(x):
        x = x.detach().clone() if torch.is_tensor(x) else torch.from_numpy(np.array(x))
        return x.to(dev, torch.float32).requires_grad_(True)

    w, b = map(param, init if init is not None else init_head(dim, num_classes, seed))
    velocity = [torch.zeros_like(w), torch.zeros_like(b)]
    run_mean = torch.zeros(dim, dtype=torch.float32, device=dev)
    run_var = torch.ones(dim, dtype=torch.float32, device=dev)

    def step(x, y, lr):
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        xn = (x - mean) / torch.sqrt(var + bn_eps)
        n = x.shape[0]
        run_mean.mul_(1 - bn_momentum).add_(bn_momentum * mean)
        run_var.mul_(1 - bn_momentum).add_(bn_momentum * (var * n / max(n - 1, 1)))
        loss = F.cross_entropy(xn @ w + b, y)
        grads = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            for p, v, g in zip((w, b), velocity, grads):
                v.mul_(0.9).add_(g)
                p.sub_(lr * v)

    rng = np.random.default_rng(seed)
    best = 0.0
    for epoch in range(epochs):
        order = torch.from_numpy(rng.permutation(num_train)).to(dev)
        for s in range(steps_per_epoch):
            lr = linprob_lr(s / steps_per_epoch + epoch, peak_lr, warmup_epochs, epochs)
            idx = order[s * batch_size:(s + 1) * batch_size]
            step(xs[idx], ys[idx], float(lr))
        with torch.no_grad():
            logits = (xs_te - run_mean) / torch.sqrt(run_var + bn_eps) @ w + b
            best = max(best, float((logits.argmax(-1) == ys_te).to(torch.float64).mean()))
    if head is not None:
        head.update(w=w.detach(), b=b.detach(), running_mean=run_mean, running_var=run_var)
    return best

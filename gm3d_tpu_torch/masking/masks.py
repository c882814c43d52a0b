"""Mask generators (True = masked / removed, matching the reference).

Port of ``gm3d_tpu/masking/masks.py``. The random functions take a
``torch.Generator`` and, optionally, the random draw itself (``noise`` /
``seed``): JAX and torch give different numbers from the same seed, so a test
feeds both sides one draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from gm3d_tpu_torch.parallel.context import draw_rows


def _rank(x: torch.Tensor) -> torch.Tensor:
    """Per-row ascending rank of each element (0 = smallest); equal elements
    rank in index order (a double STABLE argsort)."""
    order = torch.argsort(x, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _uniform(shape, generator, device) -> torch.Tensor:
    gen_device = generator.device if generator is not None else device
    return draw_rows(lambda s: torch.rand(s, generator=generator, device=gen_device),
                     shape).to(device)


def random_mask(generator: Optional[torch.Generator], batch: int, num_groups: int,
                num_mask: int, noise: Optional[torch.Tensor] = None,
                device="cpu") -> torch.Tensor:
    """Uniform random mask with exactly ``num_mask`` True per row. ``noise``
    (batch, num_groups), if given, replaces the draw."""
    if noise is None:
        noise = _uniform((batch, num_groups), generator, torch.device(device))
    return _rank(noise) < num_mask


def block_mask(generator: Optional[torch.Generator], centers: torch.Tensor, num_mask: int,
               seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Contiguous block mask: the ``num_mask`` groups nearest to one random
    seed center. ``seed`` (batch,) integer indices, if given, replace the draw."""
    batch, num_groups, _ = centers.shape
    if seed is None:
        gen_device = generator.device if generator is not None else centers.device
        seed = draw_rows(lambda s: torch.randint(0, num_groups, s, generator=generator,
                                                 device=gen_device), (batch,))
    seed = seed.to(centers.device).long()
    seed_pt = torch.gather(centers, 1, seed[:, None, None].expand(-1, 1, 3))  # (B, 1, 3)
    dist = ((centers - seed_pt) ** 2).sum(-1)  # (B, G)
    return _rank(dist) < num_mask


def gm3d_num_mask(num_groups: int, mask_ratio: float) -> int:
    """Masked-slot count of the GM3D ``generate_mask``:
    ``L - int(L * (1 - mask_ratio))``.

    NOT ``int(L * mask_ratio)``: at the default ratio 0.6 with L=64 this is
    64 - int(25.6) = 39 groups, not 38."""
    return num_groups - int(num_groups * (1.0 - mask_ratio))


def keep_ratio_schedule(epoch: float, total_epochs: int, after_200_epoch: bool = False,
                        legacy: bool = False) -> float:
    """Fraction of the masked slots chosen by predicted loss, ramped over
    training. ``legacy`` selects the older student variant's uncapped
    slope-0.5 ramp."""
    if legacy:
        return float(epoch + 1) / total_epochs * 0.5
    if after_200_epoch:
        return min(float(epoch + 1) / (total_epochs / 2) * 0.5, 0.5)
    return float(epoch + 1) / total_epochs * 0.8


def geometric_mask(generator: Optional[torch.Generator], loss_pred: torch.Tensor,
                   num_mask: int, keep_ratio: float,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Geometric-complexity mask selection.

    Of the ``num_mask`` masked slots, the ``floor(num_mask * keep_ratio)``
    groups with the HIGHEST predicted loss are masked deterministically; the
    remainder are drawn uniformly from the other groups. ``noise`` (B, G)
    uniform in [0, 1), if given, replaces the draw.

    loss_pred: (B, G) per-group predicted loss (EMA model, unmasked pass).
    Returns (B, G) bool, True = masked.
    """
    _, num_groups = loss_pred.shape
    # the product is taken in fp32, as the JAX step takes it on a traced scalar
    len_loss = int(torch.floor(torch.tensor(keep_ratio, dtype=torch.float32) * num_mask))
    loss_rank = _rank(loss_pred.to(torch.float32))  # ascending
    by_loss = loss_rank >= (num_groups - len_loss)
    if noise is None:
        noise = _uniform(loss_pred.shape, generator, loss_pred.device)
    noise = noise.to(device=loss_pred.device, dtype=torch.float32)
    # top-loss groups get a key above every noise value, so they are always
    # masked; the rest compete by uniform noise for the remaining slots
    key = torch.where(by_loss, 2.0 + loss_rank.to(torch.float32), noise)
    return _rank(-key) < num_mask

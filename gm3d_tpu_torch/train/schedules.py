"""LR / EMA / loss-weight schedules matching the reference semantics.

Port of ``gm3d_tpu/train/schedules.py`` as plain Python floats (the torch
step takes its epoch-dependent knobs as call-time floats).
"""

from __future__ import annotations

import math


def cosine_warmup_schedule(base_lr: float, min_lr: float, warmup_epochs: float,
                           total_epochs: float, steps_per_epoch: int):
    """Per-iteration linear warmup + half-cycle cosine decay, evaluated at the
    fractional epoch ``step / steps_per_epoch``."""

    def schedule(step) -> float:
        epoch = step / steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * epoch / max(warmup_epochs, 1e-8)
        denom = max(total_epochs - warmup_epochs, 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (epoch - warmup_epochs) / denom))

    return schedule


def legacy_cosine_epoch_schedule(base_lr: float, total_epochs: float, warmup_epochs: float,
                                 steps_per_epoch: int, lr_min: float = 1e-6,
                                 warmup_lr_init: float = 1e-6):
    """The legacy runners' schedule, with which the Point-MAE teacher was
    trained (timm ``CosineLRScheduler(t_in_epochs=True, warmup_prefix=False)``
    stepped at the END of each epoch): the rate is constant within an epoch,
    the warm-up is linear from ``warmup_lr_init``, the cosine is taken at the
    raw epoch, and every epoch trains at the previous epoch's value (epoch 0
    at the warm-up's start): ``t = max(epoch - 1, 0)``."""

    def schedule(step) -> float:
        t = max(math.floor(step / steps_per_epoch) - 1.0, 0.0)
        if t < warmup_epochs:
            return warmup_lr_init + (base_lr - warmup_lr_init) * t / max(warmup_epochs, 1e-8)
        return lr_min + (base_lr - lr_min) * 0.5 * (1.0 + math.cos(math.pi * t / total_epochs))

    return schedule


def effective_lr(blr: float, batch_size: int, accum_iter: int = 1, world_size: int = 1) -> float:
    """MAE lr scaling: lr = blr * eff_batch / 256."""
    return blr * batch_size * accum_iter * world_size / 256.0


def ema_decay_schedule(epoch: float) -> float:
    """EMA decay ramp 0.999 -> 0.9999 over the first 100 epochs."""
    if epoch < 100:
        return 0.999 + epoch / 100.0 * (0.9999 - 0.999)
    return 0.9999


def loss_weights(epoch: float, after_epoch: int, multipliers=(13.889, 1000.0)):
    """Loss-mix switch: (1, 1) before ``after_epoch``, then the configured
    multipliers."""
    if epoch < after_epoch:
        return 1.0, 1.0
    return float(multipliers[0]), float(multipliers[1])

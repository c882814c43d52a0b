"""On-device point-cloud augmentations.

Port of ``gm3d_tpu/data/transforms.py``, so far the one augmentation active
in pretraining and fine-tune. The function takes a ``torch.Generator`` or the
draws themselves, so that a test can feed the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional

import torch


def scale_and_translate(generator: Optional[torch.Generator], pts: torch.Tensor,
                        scale_low: float = 2.0 / 3.0, scale_high: float = 3.0 / 2.0,
                        translate_range: float = 0.2,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample anisotropic scale + translate. ``scale`` and ``shift``
    (batch, 1, 3), if given, replace the draws (scale first, then shift)."""
    batch = pts.shape[0]

    def uniform(low, high):
        gen_device = generator.device if generator is not None else pts.device
        u = torch.rand((batch, 1, 3), generator=generator, device=gen_device)
        return (u * (high - low) + low).to(pts.device)

    if scale is None:
        scale = uniform(scale_low, scale_high)
    if shift is None:
        shift = uniform(-translate_range, translate_range)
    return pts * scale.to(pts) + shift.to(pts)

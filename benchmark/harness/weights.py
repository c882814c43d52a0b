"""Weights made from the seed on the device, in two large random calls.

The names and shapes come from the plain reference's module (built on the
meta device), so that loading them into the program with ``strict=True``
also proves that the two agree on every tensor. Every tensor is random, the
norms' scales and the BatchNorm statistics too, so that a layer the program
computes wrongly cannot hide behind an initial value of 0 or 1:

  - a matrix or token (2 or more axes): normal, std 0.02, cut at 2 std;
  - a norm's scale (1 axis, named ``weight``): 1 + 0.1 normal;
  - any other vector (biases, ``running_mean``): 0.02 normal;
  - ``running_var``: uniform in [0.5, 1.5);
  - ``num_batches_tracked``: 0.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Spec = Sequence[Tuple[str, Tuple[int, ...], torch.dtype]]


def spec_of(module: torch.nn.Module) -> list:
    """(name, shape, dtype) of every tensor of ``module``'s state dict, in order."""
    return [(n, tuple(t.shape), t.dtype) for n, t in module.state_dict().items()]


def make_state(spec: Spec, seed: int, device, salt: int = 0) -> Dict[str, torch.Tensor]:
    """The state dict of ``spec`` drawn from ``seed`` (and ``salt``, one a
    model) on ``device``."""
    gen = torch.Generator(device=device).manual_seed((int(seed) * 7919 + 104729 * salt + 17)
                                                     % (2 ** 63))
    floats = [(n, s, d) for n, s, d in spec if d.is_floating_point]
    sizes = [int(torch.Size(s).numel()) for _, s, _ in floats]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for (name, shape, dtype), size in zip(floats, sizes):
        n = normal[offset:offset + size].view(shape)
        u = uniform[offset:offset + size].view(shape)
        offset += size
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            t = 0.5 + u
        elif len(shape) >= 2:
            t = 0.02 * n.clamp(-2.0, 2.0)
        elif leaf == "weight":
            t = 1.0 + 0.1 * n
        else:
            t = 0.02 * n
        out[name] = t.to(dtype).clone()
    for name, shape, dtype in spec:
        if name not in out:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return {name: out[name] for name, _, _ in spec}

"""Device and dtype resolution shared by the entry points.

No JAX counterpart: JAX picks its backend globally, PyTorch takes an explicit
device. Entry points of this package default to ``"cuda"`` and raise when
there is none; the CPU is used only when the caller asks for it."""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``torch.device`` for ``device``; a CUDA device that does not exist
    raises ``RuntimeError`` instead of continuing on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available "
                "(torch.cuda.is_available() is False); pass device='cpu' "
                "(--device cpu) to run on the CPU on purpose")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (expected cuda or cpu)")
    return dev


def dtype_name(dtype: torch.dtype) -> str:
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"unsupported compute dtype {dtype} (expected float32 or bfloat16)")


def dtype_from_name(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {name!r} (expected one of {sorted(_DTYPES)})")
    return _DTYPES[name]

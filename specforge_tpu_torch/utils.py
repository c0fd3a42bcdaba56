"""Small shared helpers of the PyTorch port."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device given and no CUDA device present this raises; the port
    never moves to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda")


def to_device(tensors: Mapping[str, Any], device: torch.device) -> Dict[str, Any]:
    """Move every tensor of a flat mapping to ``device`` (others unchanged)."""
    return {
        k: v.to(device) if isinstance(v, torch.Tensor) else v
        for k, v in tensors.items()
    }


def shift_pad(x: torch.Tensor, left: bool = True) -> torch.Tensor:
    """Shift a [B, S, ...] tensor one step along the sequence axis, zero-filling.

    ``left=True``  → prepend a zero row, drop the last (shift right in time).
    ``left=False`` → drop the first row, append a zero (shift left in time).
    """
    zeros = torch.zeros_like(x[:, -1:])
    if left:
        return torch.cat([zeros, x[:, :-1]], dim=1)
    return torch.cat([x[:, 1:], zeros], dim=1)


def model_device(module: torch.nn.Module) -> Optional[torch.device]:
    for p in module.parameters():
        return p.device
    return None

"""Which device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device. Without a card this raises instead of
    carrying on on the CPU; pass ``"cpu"`` to run there deliberately."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU deliberately")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device``; the CPU has none queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

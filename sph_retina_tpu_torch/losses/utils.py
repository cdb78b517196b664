"""Loss reduction helpers (mmdet ``weighted_loss`` semantics, mask-aware).

Batches are padded and masked, so ``weight`` doubles as the validity mask and
``avg_factor`` carries the true sample count. ``avg_factor`` may be a 0-dim
tensor on the device: nothing here reads it back to the host.
"""

from __future__ import annotations

import torch


def weight_reduce_loss(
    loss: torch.Tensor,
    weight: torch.Tensor | None = None,
    reduction: str = "mean",
    avg_factor: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Apply elementwise weight then reduce.

    ``avg_factor`` overrides the denominator of the mean (the number of
    *valid* samples in a padded batch).
    """
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"unknown reduction {reduction!r}")
    if avg_factor is None:
        if weight is not None:
            denom = weight.sum().clamp_min(1e-6)
        else:
            denom = loss.numel()
        return loss.sum() / denom
    if isinstance(avg_factor, torch.Tensor):
        return loss.sum() / avg_factor.clamp_min(1e-6)
    return loss.sum() / max(avg_factor, 1e-6)


def reduce_box_weight(weight: torch.Tensor | None) -> torch.Tensor | None:
    """(N, D) per-coordinate weights -> (N,) per-box (mmdet convention)."""
    if weight is not None and weight.ndim > 1:
        return weight.mean(dim=-1)
    return weight

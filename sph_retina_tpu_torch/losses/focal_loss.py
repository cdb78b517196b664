"""Sigmoid focal loss and cross-entropy in plain PyTorch, fp32.

Semantics: per-class sigmoid, background encoded as label == num_classes
(one-hot of all zeros).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .utils import weight_reduce_loss


def sigmoid_focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: torch.Tensor | None = None,
    *,
    gamma: float = 2.0,
    alpha: float = 0.25,
    reduction: str = "mean",
    avg_factor=None,
    loss_weight: float = 1.0,
) -> torch.Tensor:
    """Focal loss for (N, C) logits and (N,) integer labels in [0, C].

    label == C means background (all-zero one-hot target).
    """
    num_classes = logits.shape[-1]
    # a comparison, not an index: label C matches no class, a row of zeros
    classes = torch.arange(num_classes, device=logits.device)
    target = (labels[..., None] == classes).to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_weight = (alpha * target + (1.0 - alpha) * (1.0 - target)) \
        * pt.pow(gamma)
    loss = _bce_with_logits(logits, target) * focal_weight
    if weight is not None and weight.ndim + 1 == loss.ndim:
        weight = weight[..., None]
    return loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)


def _bce_with_logits(logits, target):
    # log(1 + exp(-|x|)) formulation, numerically stable
    return logits.clamp_min(0.0) - logits * target + torch.log1p(
        torch.exp(-logits.abs()))


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weight: torch.Tensor | None = None,
    *,
    reduction: str = "mean",
    avg_factor=None,
    loss_weight: float = 1.0,
) -> torch.Tensor:
    """Softmax CE for (N, C) logits, (N,) int labels."""
    log_probs = F.log_softmax(logits, dim=-1)
    loss = -log_probs.gather(-1, labels.to(torch.int64)[..., None])[..., 0]
    return loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)

"""L1-family regression losses.

- ``sph_l1_loss``: plain L1 on (encoded) box parameters (``SphL1Loss`` is
  mmdet's stock L1Loss).
- ``smooth_l1_loss``: the beta-smoothed variant (mmdet SmoothL1Loss).

``sph2pob_l1_loss`` (L1 on the deltas of the Sph2Pob-transformed pair) waits
for the Sph2Pob transform and is not part of this package yet.
"""

from __future__ import annotations

import torch

from .utils import weight_reduce_loss


def l1_terms(pred, target):
    return (pred - target).abs()


def smooth_l1_terms(pred, target, beta: float = 1.0):
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def sph_l1_loss(pred, target, weight=None, *, reduction="mean",
                avg_factor=None, loss_weight: float = 1.0):
    return loss_weight * weight_reduce_loss(
        l1_terms(pred, target), weight, reduction, avg_factor)


def smooth_l1_loss(pred, target, weight=None, *, beta: float = 1.0,
                   reduction="mean", avg_factor=None,
                   loss_weight: float = 1.0):
    return loss_weight * weight_reduce_loss(
        smooth_l1_terms(pred, target, beta), weight, reduction, avg_factor)

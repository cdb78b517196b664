"""IoU-family regression losses on planar oriented boxes and spherical boxes.

``sph2pob_iou_loss`` (``Sph2PobIoULoss``): iou / giou / diou / ciou on the
Sph2Pob-transformed pair, whose IoU is the differentiable sort-free clip of
``iou/rotated.py``; ``sph_iou_loss`` (``SphIoULoss``): 1 - IoU straight from
the spherical boxes through ``sph_overlaps``. Both are plain differentiable
PyTorch, as in the JAX package; neither goes through the fused kernels,
which have no backward.
"""

from __future__ import annotations

import math

import torch

from ..boxes.formator import obb2hbb_xyxy
from ..iou.api import sph_overlaps
from ..iou.rotated import rotated_box_iou
from .sph2pob_loss import sph2pob_pairs
from .utils import reduce_box_weight, weight_reduce_loss


def obb_iou_loss_terms(pred: torch.Tensor, target: torch.Tensor, mode: str,
                       eps: float = 1e-7) -> torch.Tensor:
    """Per-element IoU-family loss of rotated boxes (..., 5), angles in
    radians."""
    ious = rotated_box_iou(pred, target).clamp(0.0, 1.0)
    if mode == "iou":
        return 1.0 - ious

    hbb_p = obb2hbb_xyxy(pred)
    hbb_t = obb2hbb_xyxy(target)
    enc_tl = torch.minimum(hbb_p[..., :2], hbb_t[..., :2])
    enc_br = torch.maximum(hbb_p[..., 2:], hbb_t[..., 2:])
    enc_wh = (enc_br - enc_tl).clamp_min(0.0)

    if mode == "giou":
        int_tl = torch.maximum(hbb_p[..., :2], hbb_t[..., :2])
        int_br = torch.minimum(hbb_p[..., 2:], hbb_t[..., 2:])
        int_wh = (int_br - int_tl).clamp_min(0.0)
        area_enc = enc_wh[..., 0] * enc_wh[..., 1]
        area_int = int_wh[..., 0] * int_wh[..., 1]
        area_p = pred[..., 2] * pred[..., 3]
        area_t = target[..., 2] * target[..., 3]
        union = area_p + area_t - area_int
        ratio = ((area_enc - union) / (area_enc + eps)).clamp(0.0, 1.0)
        return 1.0 - (ious - ratio)

    c2 = enc_wh[..., 0] ** 2 + enc_wh[..., 1] ** 2 + eps
    rho2 = (target[..., 0] - pred[..., 0]) ** 2 \
        + (target[..., 1] - pred[..., 1]) ** 2
    center_term = (rho2 / c2).clamp(0.0, 1.0)

    if mode == "diou":
        return 1.0 - (ious - center_term)

    if mode == "ciou":
        factor = 4.0 / math.pi ** 2
        v = factor * (
            torch.atan(target[..., 2] / (target[..., 3] + eps))
            - torch.atan(pred[..., 2] / (pred[..., 3] + eps))) ** 2
        alpha = ((ious > 0.5).to(v.dtype) * v
                 / (1.0 - ious + v + eps)).detach()
        return 1.0 - (ious - (center_term + alpha * v))

    raise ValueError(f"unsupported iou loss mode {mode!r}")


def sph2pob_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                     weight: torch.Tensor | None = None, *, mode: str = "iou",
                     transform: str = "sph2pob_standard", eps: float = 1e-7,
                     reduction: str = "mean", avg_factor=None,
                     loss_weight: float = 1.0) -> torch.Tensor:
    """Sph2PobIoULoss: spherical boxes in degrees (..., 4|5)."""
    pob_p, pob_t = sph2pob_pairs(pred, target, transform)
    loss = obb_iou_loss_terms(pob_p, pob_t, mode, eps)
    return loss_weight * weight_reduce_loss(
        loss, reduce_box_weight(weight), reduction, avg_factor)


def sph_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                 weight: torch.Tensor | None = None, *,
                 iou_calculator: str = "sph2pob_standard",
                 reduction: str = "mean", avg_factor=None,
                 loss_weight: float = 1.0) -> torch.Tensor:
    """SphIoULoss: 1 - IoU straight from spherical inputs (degrees)."""
    ious = sph_overlaps(pred, target, iou_calculator, is_aligned=True)
    loss = 1.0 - ious.clamp(0.0, 1.0)
    return loss_weight * weight_reduce_loss(
        loss, reduce_box_weight(weight), reduction, avg_factor)

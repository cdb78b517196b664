"""L1-family regression losses.

- ``sph_l1_loss``: plain L1 on (encoded) box parameters (``SphL1Loss`` is
  mmdet's stock L1Loss).
- ``sph2pob_l1_loss``: L1 on 5-dof deltas of the Sph2Pob-transformed pair
  (``Sph2PobL1Loss``), with the delta and angle-wrap semantics of the
  original code base.
- ``smooth_l1_loss``: the beta-smoothed variant (mmdet SmoothL1Loss).
"""

from __future__ import annotations

import math

import torch

from .sph2pob_loss import sph2pob_pairs
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


def _wrap_angle(angle, modifier: str):
    if modifier == "original":
        return angle
    if modifier == "modulus":
        return torch.remainder(angle + math.pi, math.pi)
    raise ValueError(f"unsupported angle modifier {modifier!r}")


def obb2delta(proposals, gt, angle_modifier: str = "original",
              eps: float = 1e-7):
    """5-dof deltas of gt w.r.t. proposals (both (..., 5) rotated boxes)."""
    px, py, pw, ph, pa = proposals.unbind(-1)
    gx, gy, gw, gh, ga = gt.unbind(-1)
    pw, ph = pw.clamp_min(eps), ph.clamp_min(eps)
    gw, gh = gw.clamp_min(eps), gh.clamp_min(eps)
    dx = (gx - px) / pw
    dy = (gy - py) / ph
    dw = torch.log(gw / pw)
    dh = torch.log(gh / ph)
    da = (_wrap_angle(ga, angle_modifier)
          - _wrap_angle(pa, angle_modifier)) / math.pi
    return torch.stack([dx, dy, dw, dh, da], dim=-1)


def sph2pob_l1_loss(pred, target, weight=None, *,
                    transform: str = "sph2pob_standard", encode: bool = True,
                    swap: bool = False, angle_modifier: str = "original",
                    reduction: str = "mean", avg_factor=None,
                    loss_weight: float = 1.0):
    """L1 on Sph2Pob deltas; spherical degree boxes in (..., 4|5)."""
    box_version = target.shape[-1]
    pob_p, pob_t = sph2pob_pairs(pred, target, transform)
    if encode:
        if swap:
            deltas = obb2delta(pob_t, pob_p, angle_modifier)
        else:
            deltas = obb2delta(pob_p, pob_t, angle_modifier)
        loss = deltas.abs()
    else:
        loss = (pob_p - pob_t).abs()
    if weight is not None and weight.ndim == loss.ndim and box_version == 4:
        # (N, 4) weights are padded with their mean for the angle column
        weight = torch.cat([weight, weight.mean(-1, keepdim=True)], dim=-1)
    return loss_weight * weight_reduce_loss(loss, weight, reduction,
                                            avg_factor)

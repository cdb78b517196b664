"""Planar approximate spherical IoUs: Sph-IoU and FoV-IoU.

Competitor baselines: axis-aligned rectangle intersection in a
longitude/latitude chart.

- Sph-IoU (AAAI'20 "Spherical criteria..."): raw chart coordinates.
- FoV-IoU (arXiv 2202.03176): longitude deltas rescaled by cos(mean latitude).

Boxes are (..., 4) in **degrees** (theta, phi, alpha, beta); callers apply
``standardize_spherical_box`` first to avoid the seam (``iou/api.py`` does).
Elementwise over leading axes.
"""

from __future__ import annotations

import math

import torch


def _to_convention_rad(boxes: torch.Tensor):
    """Degrees (theta in [0, 360), phi colatitude) -> radians (longitude in
    (-pi, pi), latitude, alpha, beta)."""
    b = torch.deg2rad(boxes)
    return b[..., 0] - math.pi, math.pi / 2.0 - b[..., 1], b[..., 2], b[..., 3]


def _chart_iou(x_min, x_max, y_min, y_max, a1, b1, a2, b2, eps):
    inter = (x_max - x_min).clamp_min(0.0) * (y_max - y_min).clamp_min(0.0)
    union = a1 * b1 + a2 * b2 - inter
    return inter / (union + eps)


def sph_iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor,
                    eps: float = 1e-8):
    lon1, lat1, a1, b1 = _to_convention_rad(boxes1)
    lon2, lat2, a2, b2 = _to_convention_rad(boxes2)
    return _chart_iou(
        torch.maximum(lon1 - a1 / 2, lon2 - a2 / 2),
        torch.minimum(lon1 + a1 / 2, lon2 + a2 / 2),
        torch.maximum(lat1 - b1 / 2, lat2 - b2 / 2),
        torch.minimum(lat1 + b1 / 2, lat2 + b2 / 2),
        a1, b1, a2, b2, eps)


def fov_iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor,
                    eps: float = 1e-8):
    lon1, lat1, a1, b1 = _to_convention_rad(boxes1)
    lon2, lat2, a2, b2 = _to_convention_rad(boxes2)
    # FoV-space longitude offset of box 2 relative to box 1
    delta = (lon2 - lon1) * torch.cos((lat1 + lat2) / 2.0)
    return _chart_iou(
        torch.maximum(-a1 / 2, delta - a2 / 2),
        torch.minimum(a1 / 2, delta + a2 / 2),
        torch.maximum(lat1 - b1 / 2, lat2 - b2 / 2),
        torch.minimum(lat1 + b1 / 2, lat2 + b2 / 2),
        a1, b1, a2, b2, eps)

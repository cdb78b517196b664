"""Epsilon jitter against degenerate box pairs.

Rotated-rectangle intersection is numerically unstable when two boxes share
edges or corners exactly (collinear edges give 0/0 in the line-intersection
solve). Near-identical pairs are nudged apart before the transform and
clamped into the open valid ranges, without in-place mutation.

This is the unfused form over stacked ``(..., D)`` boxes, used by the
``sph_overlaps`` backends and the losses; ``ops/fused_iou.py`` keeps its own
componentwise copy for the kernels' plain version. The constants are the JAX
package's, exactly. Every bound is a Python number: no small tensor is copied
to the card (a blocking copy) on a training step.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-4 * 1.2345678
_ANG_EPS = 1e-3 * 1.2345678


def _clamp_columns(boxes: torch.Tensor, lo, hi) -> torch.Tensor:
    return torch.stack([c.clamp(a, b) for c, a, b
                        in zip(boxes.unbind(-1), lo, hi)], dim=-1)


def jitter_spherical_boxes(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Nudge near-identical spherical box pairs apart (degrees in and out).

    A pair with some coordinate closer than ~1.2e-4 degrees is shifted:
    box1 -= 2 eps, box2 += eps (all columns); then both are clamped into the
    open ranges theta in (0, 360), phi/alpha/beta in (0, 180), gamma in
    (-360, 360), with eps margins (box 1 and box 2 mirrored).
    """
    eps = _EPS
    similar = ((boxes1 - boxes2).abs() < eps).any(-1, keepdim=True)
    boxes1 = torch.where(similar, boxes1 - 2.0 * eps, boxes1)
    boxes2 = torch.where(similar, boxes2 + eps, boxes2)

    lo1 = [2 * eps] * 4
    hi1 = [360.0 - eps] + [180.0 - eps] * 3
    lo2 = [eps] * 4
    hi2 = [360.0 - 2 * eps] + [180.0 - 2 * eps] * 3
    if boxes1.shape[-1] == 5:
        lo1.append(-360.0 + 2 * eps)
        hi1.append(360.0 - eps)
        lo2.append(-360.0 + eps)
        hi2.append(360.0 - 2 * eps)
    return _clamp_columns(boxes1, lo1, hi1), _clamp_columns(boxes2, lo2, hi2)


def jitter_rotated_boxes(pob1: torch.Tensor, pob2: torch.Tensor):
    """Nudge near-identical rotated boxes (cx, cy, w, h, ang_rad) apart."""
    eps = _EPS
    x1, y1, w1, h1, a1 = pob1.unbind(-1)
    x2, y2, w2, h2, a2 = pob2.unbind(-1)
    similar = ((x1 - x2).abs() < eps) | ((w1 - w2).abs() < eps) \
        | ((h1 - h2).abs() < eps) | ((a1 - a2).abs() < eps)

    def shift(v, d):
        return torch.where(similar, v + d, v)

    x1, y1, w1, h1, a1 = (shift(v, d) for v, d in zip(
        (x1, y1, w1, h1, a1), (eps, eps, 2 * eps, 2 * eps, eps)))
    x2, y2, w2, h2, a2 = (shift(v, d) for v, d in zip(
        (x2, y2, w2, h2, a2), (2 * eps, 2 * eps, eps, eps, 5 * eps)))

    # separate near-equal angles a bit more aggressively
    ang_close = (a1 - a2).abs() < _ANG_EPS
    a1 = a1 + torch.where(ang_close, _ANG_EPS, 0.0)
    a2 = a2 + torch.where(ang_close, 2.0 * _ANG_EPS, 0.0)

    two_pi = 2.0 * math.pi
    pob1 = torch.stack([x1, y1, w1.clamp_min(2 * eps / 10.0),
                        h1.clamp_min(2 * eps / 10.0),
                        a1.clamp(-two_pi + 2 * eps, two_pi - eps)], dim=-1)
    pob2 = torch.stack([x2, y2, w2.clamp_min(eps / 10.0),
                        h2.clamp_min(eps / 10.0),
                        a2.clamp(-two_pi + eps, two_pi - 2 * eps)], dim=-1)
    return pob1, pob2

"""Sph2Pob loss adapter: spherical boxes (degrees) -> planar oriented pairs.

Every planar-OBB loss becomes a spherical loss by jittering the pair, running
the (differentiable) Sph2Pob transform and jittering the resulting rotated
boxes. The transform depends on the pair, so it runs per (pred, target) pair
inside the loss, not as a preprocessing step. Plain PyTorch, differentiable,
on whatever device the boxes lie on; the fused kernels have no backward and
are not used here.
"""

from __future__ import annotations

import torch

from ..geometry.jitter import jitter_rotated_boxes, jitter_spherical_boxes
from ..geometry.sph2pob import TRANSFORMS


def sph2pob_pairs(pred: torch.Tensor, target: torch.Tensor,
                  transform: str = "sph2pob_standard"):
    """Spherical (degrees, (..., 4|5)) -> rotated-box pairs (radians,
    (..., 5))."""
    pred, target = jitter_spherical_boxes(pred, target)
    pob_p, pob_t = TRANSFORMS[transform](torch.deg2rad(pred),
                                         torch.deg2rad(target))
    return jitter_rotated_boxes(pob_p, pob_t)

"""Spherical box primitives.

Elementwise torch functions over tensors whose last axis holds box
parameters, shape-polymorphic over the leading axes and differentiable
(every division and square root a masked branch could see is guarded, so
``backward`` stays finite). The seeded box generator is numpy, on the host.

Conventions, as in the JAX package:

- BFoV box   = (theta, phi, alpha, beta)          [degrees at the public API]
- RBFoV box  = (theta, phi, alpha, beta, gamma)
- theta in [0, 360): longitude of the centre, phi in [0, 180): colatitude,
  alpha/beta in (0, 180): angular extents, gamma: rotation about the view axis.

The unit-sphere embedding used throughout:
    x = sin(phi) cos(theta),  y = sin(phi) sin(theta),  z = cos(phi)

3-vector products are written as explicit multiply-sums and
``torch.linalg.cross(..., dim=-1)``, never as ``matmul`` / ``einsum``: on the
card those may run in TF32, whose ~1e-3 error would break the geometry.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-7


def sph_to_unit_vec(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Embed spherical angles (radians) as unit vectors, shape (..., 3)."""
    sin_phi = torch.sin(phi)
    return torch.stack([sin_phi * torch.cos(theta), sin_phi * torch.sin(theta),
                        torch.cos(phi)], dim=-1)


def longitude_tangent(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Unit tangent along the longitude great circle (d/dphi of the
    embedding), pointing towards growing colatitude; shape (..., 3)."""
    cos_phi = torch.cos(phi)
    return torch.stack([cos_phi * torch.cos(theta), cos_phi * torch.sin(theta),
                        -torch.sin(phi)], dim=-1)


def unit_vec_to_sph(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`sph_to_unit_vec`: (theta in (-pi, pi], phi in
    [0, pi]) in radians."""
    x, y, z = v.unbind(-1)
    norm = torch.sqrt((v * v).sum(-1))
    phi = torch.arccos((z / norm.clamp_min(EPS)).clamp(-1.0 + EPS, 1.0 - EPS))
    return torch.atan2(y, x), phi


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Safe L2 normalisation along the last axis."""
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / n.clamp_min(eps)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the LAST axis, broadcasting (``torch.cross``
    without ``dim`` takes the first axis of size 3 instead)."""
    return torch.linalg.cross(a, b, dim=-1)


def angle_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned angle (radians) between direction vectors, last axis = 3.

    The cosine is clipped to +-(1 - 1e-7), so identical directions give a
    small positive angle rather than an exact zero with an unstable gradient.
    """
    cos_val = (normalize(a) * normalize(b)).sum(-1)
    return torch.arccos(cos_val.clamp(-1.0 + EPS, 1.0 - EPS))


def rotation_sign(a: torch.Tensor, b: torch.Tensor,
                  ref: torch.Tensor) -> torch.Tensor:
    """+1 where a->b turns clockwise w.r.t. ``ref`` (cross(a, b) points
    against it), else -1."""
    crit = (cross(a, b) * ref).sum(-1) < 0
    return torch.where(crit, 1.0, -1.0).to(a.dtype)


def standardize_spherical_box(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Shift theta by 180 degrees (mod 360) for pairs straddling the seam, so
    that planar approximations see no wrap-around. Degrees in and out."""
    t1, t2 = boxes1[..., 0], boxes2[..., 0]
    move = (t1 - t2).abs() > 180.0
    t1 = torch.where(move, torch.remainder(t1 + 180.0, 360.0), t1)
    t2 = torch.where(move, torch.remainder(t2 + 180.0, 360.0), t2)
    return (torch.cat([t1[..., None], boxes1[..., 1:]], dim=-1),
            torch.cat([t2[..., None], boxes2[..., 1:]], dim=-1))


def spherical_box_area(alpha: torch.Tensor,
                       beta: torch.Tensor) -> torch.Tensor:
    """Exact area of a spherical rectangle with FoVs (alpha, beta), radians:
    A = 4 arccos(-sin(a/2) sin(b/2)) - 2 pi."""
    s = -torch.sin(alpha / 2.0) * torch.sin(beta / 2.0)
    return 4.0 * torch.arccos(s.clamp(-1.0 + EPS, 1.0 - EPS)) - 2.0 * math.pi


def is_valid_boxes(boxes: torch.Tensor, need_flag: bool = False):
    """Validity predicate for degree-space boxes, with inclusive bounds
    (theta <= 360, phi <= 180, alpha <= 360, beta <= 180, and gamma in
    [-180, 180] at D=5): the decoder's clamps land exactly on them.
    ``need_flag``: the per-box flags, else whether every box is valid."""
    theta, phi, alpha, beta = (boxes[..., i] for i in range(4))
    flag = ((theta >= 0.0) & (theta <= 360.0)
            & (phi >= 0.0) & (phi <= 180.0)
            & (alpha >= 0.0) & (alpha <= 360.0)
            & (beta >= 0.0) & (beta <= 180.0))
    if boxes.shape[-1] == 5:
        gamma = boxes[..., 4]
        flag = flag & (gamma >= -180.0) & (gamma <= 180.0)
    if need_flag:
        return flag
    return flag.all()


def generate_boxes(
    n: int,
    box_version: int = 4,
    *,
    theta_range=(0.0, 360.0),
    phi_range=(0.0, 180.0),
    fov_range=(1.0, 100.0),
    gamma_range=(-90.0, 90.0),
    seed: int = 0,
    dtype=np.float32,
) -> np.ndarray:
    """Uniform random spherical boxes in degrees, (n, box_version); the same
    numbers from the same seed as the JAX package's generator."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(*theta_range, size=(n, 1))
    phi = rng.uniform(*phi_range, size=(n, 1))
    alpha = rng.uniform(*fov_range, size=(n, 1))
    beta = rng.uniform(*fov_range, size=(n, 1))
    cols = [theta, phi, alpha, beta]
    if box_version == 5:
        cols.append(rng.uniform(*gamma_range, size=(n, 1)))
    return np.concatenate(cols, axis=1).astype(dtype)

"""Sph2Pob: spherical box pair -> planar oriented box (POB) pair.

A *pair* of spherical boxes is mapped to a *pair* of planar rotated
rectangles that keeps their relative pose, so that the rotated-rectangle IoU
approximates the spherical IoU, differentiably. Three variants, as in the JAX
package:

- ``sph2pob_efficient``: no explicit rotation. The cross product of both
  centres plays the rotated z-axis; box 1 sits at the origin and box 2 at
  (arc distance, 0).
- ``sph2pob_standard``: an explicit rotation moves both centres onto the
  equator, symmetric about (1, 0, 0); the internal angles are measured
  against the rotated z-axis.
- ``sph2pob_legacy``: hand-crafted rules (equator repositioning that keeps
  the arc length; approximate angles).

All take boxes in **radians**, (theta, phi, alpha, beta[, gamma]) on the last
axis, and return two (..., 5) rotated boxes (cx, cy, w, h, angle_rad). The
3x3 products are explicit multiply-sums (see ``geometry/boxes.py``).
"""

from __future__ import annotations

import math

import torch

from .boxes import (
    angle_between,
    cross,
    longitude_tangent,
    normalize,
    rotation_sign,
    sph_to_unit_vec,
)


def _edge_length(fov: torch.Tensor, mode: str) -> torch.Tensor:
    """Planar edge length for an angular FoV."""
    if mode == "arc":
        return fov
    if mode == "tangent":
        return 2.0 * torch.tan(fov / 2.0)
    if mode == "chord":
        return 2.0 * torch.sin(fov / 2.0)
    raise ValueError(f"unsupported rbb_edge mode: {mode}")


def _split(boxes: torch.Tensor):
    return boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]


def _basis(like: torch.Tensor, axis: int) -> torch.Tensor:
    """The unit vector along ``axis``, broadcast to ``like``'s shape."""
    out = torch.zeros_like(like)
    out[..., axis] = 1.0
    return out


def _signed_angle_to_axis(direction, axis, ref, project: bool):
    """Signed angle between ``direction`` and ``axis``, positive where
    axis->direction turns clockwise w.r.t. ``ref``."""
    if project:
        direction = torch.cat([torch.zeros_like(direction[..., :1]),
                               direction[..., 1:]], dim=-1)
    ang = angle_between(direction, axis)
    return ang * rotation_sign(axis, direction, ref)


# --------------------------------------------------------------------------- #
# efficient variant (the default)
# --------------------------------------------------------------------------- #
def sph2pob_efficient(boxes1: torch.Tensor, boxes2: torch.Tensor, *,
                      rbb_edge: str = "arc", rbb_angle: str = "equator"):
    """Rotation-free Sph2Pob: (..., 4|5) radians -> two (..., 5) POBs."""
    assert rbb_angle in ("equator", "project")
    t1, p1, a1, b1 = _split(boxes1)
    t2, p2, a2, b2 = _split(boxes2)

    c1 = sph_to_unit_vec(t1, p1)
    c2 = sph_to_unit_vec(t2, p2)
    d1 = longitude_tangent(t1, p1)
    d2 = longitude_tangent(t2, p2)

    # the axis orthogonal to both centres is the z-axis of the implicit
    # rotated frame; the midpoint direction is the turning sign's reference
    axis = cross(c1, c2)
    ref = (c1 + c2) * 0.5
    arc = angle_between(c1, c2)

    ang1 = _signed_angle_to_axis(d1, axis, ref, rbb_angle == "project")
    ang2 = _signed_angle_to_axis(d2, axis, ref, rbb_angle == "project")

    if boxes1.shape[-1] == 5 and boxes2.shape[-1] == 5:
        ang1 = ang1 - boxes1[..., 4]
        ang2 = ang2 - boxes2[..., 4]

    zeros = torch.zeros_like(arc)
    pob1 = torch.stack([zeros, zeros, _edge_length(a1, rbb_edge),
                        _edge_length(b1, rbb_edge), ang1], dim=-1)
    pob2 = torch.stack([arc, zeros, _edge_length(a2, rbb_edge),
                        _edge_length(b2, rbb_edge), ang2], dim=-1)
    return pob1, pob2


# --------------------------------------------------------------------------- #
# standard variant (explicit rotation)
# --------------------------------------------------------------------------- #
def _rotate_matrix_lookat(theta, phi):
    """Rows (look, down, right): moves the point at (theta, phi) to +x."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    zero = torch.zeros_like(theta)
    look = torch.stack([sp * ct, sp * st, cp], dim=-1)
    down = torch.stack([cp * ct, cp * st, -sp], dim=-1)
    right = torch.stack([st, -ct, zero], dim=-1)
    return torch.stack([look, down, right], dim=-2)  # (..., 3, 3)


def _mat3_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as an explicit fp32 multiply-sum."""
    return (m * v[..., None, :]).sum(-1)


def _mat3_mat3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as an explicit fp32 multiply-sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _rotate_matrix_pair(c1, c2, degenerate_mask):
    """Rows (look, right, up): midpoint -> +x, centres -> equator.

    The caller replaces the degenerate (coincident-centre) rows; they get a
    safe dummy difference here so that no NaN reaches the gradient through
    the ``where``.
    """
    look = normalize(c1 + c2)
    diff = torch.where(degenerate_mask[..., None], _basis(c1, 1), c2 - c1)
    right = normalize(diff)
    up = cross(look, right)
    return torch.stack([look, right, up], dim=-2)


def _spherical_coordinate_signed(v):
    """(theta, phi) of rotated points; theta signed in (-pi, pi), measured
    against +x with a clockwise sign w.r.t. -z, phi against +z."""
    z = _basis(v, 2)
    x = _basis(v, 0)
    phi = angle_between(v, z)
    v_xy = torch.cat([v[..., :2], torch.zeros_like(v[..., 2:])], dim=-1)
    theta = angle_between(v_xy, x) * rotation_sign(x, v_xy, -z)
    return theta, phi


def _rotate_about_axis_at(theta, phi, gamma):
    """Rotation by gamma about the radial axis at (theta, phi):
    R' = T^T Rx(gamma) T with T the look-at frame."""
    t = _rotate_matrix_lookat(theta, phi)
    sg, cg = torch.sin(gamma), torch.cos(gamma)
    zero, one = torch.zeros_like(gamma), torch.ones_like(gamma)
    rx = torch.stack([
        torch.stack([one, zero, zero], dim=-1),
        torch.stack([zero, cg, -sg], dim=-1),
        torch.stack([zero, sg, cg], dim=-1),
    ], dim=-2)
    return _mat3_mat3(_mat3_mat3(t.transpose(-1, -2), rx), t)


def sph2pob_standard(boxes1: torch.Tensor, boxes2: torch.Tensor, *,
                     rbb_edge: str = "arc", rbb_angle: str = "equator",
                     eps: float = 1e-8):
    """Standard Sph2Pob with an explicit rotation."""
    assert rbb_angle in ("equator", "project")
    t1, p1, a1, b1 = _split(boxes1)
    t2, p2, a2, b2 = _split(boxes2)

    c1 = sph_to_unit_vec(t1, p1)
    c2 = sph_to_unit_vec(t2, p2)
    d1 = longitude_tangent(t1, p1)
    d2 = longitude_tangent(t2, p2)

    if boxes1.shape[-1] == 5:
        d1 = _mat3_vec(_rotate_about_axis_at(t1, p1, -boxes1[..., 4]), d1)
    if boxes2.shape[-1] == 5:
        d2 = _mat3_vec(_rotate_about_axis_at(t2, p2, -boxes2[..., 4]), d2)

    # the pair frame where the centres differ; look-at the midpoint otherwise
    degenerate = (c1 - c2).abs().sum(-1) <= eps
    r_pair = _rotate_matrix_pair(c1, c2, degenerate)
    r_mid = _rotate_matrix_lookat((t1 + t2) / 2.0, (p1 + p2) / 2.0)
    rot = torch.where(degenerate[..., None, None], r_mid, r_pair)

    rc1 = _mat3_vec(rot, c1)
    rc2 = _mat3_vec(rot, c2)
    rd1 = _mat3_vec(rot, d1)
    rd2 = _mat3_vec(rot, d2)

    z = _basis(rd1, 2)
    x = _basis(rd1, 0)
    ang1 = _signed_angle_to_axis(rd1, z, x, rbb_angle == "project")
    ang2 = _signed_angle_to_axis(rd2, z, x, rbb_angle == "project")

    th1, ph1 = _spherical_coordinate_signed(rc1)
    th2, ph2 = _spherical_coordinate_signed(rc2)

    pob1 = torch.stack([th1, ph1, _edge_length(a1, rbb_edge),
                        _edge_length(b1, rbb_edge), ang1], dim=-1)
    pob2 = torch.stack([th2, ph2, _edge_length(a2, rbb_edge),
                        _edge_length(b2, rbb_edge), ang2], dim=-1)
    return pob1, pob2


# --------------------------------------------------------------------------- #
# legacy variant (hand-crafted rules)
# --------------------------------------------------------------------------- #
def sph2pob_legacy(boxes1: torch.Tensor, boxes2: torch.Tensor, *,
                   rbb_edge: str = "arc", rbb_angle: str | None = None):
    """Hand-crafted-rule Sph2Pob: both boxes moved to the equator keeping the
    great-circle distance of their centres; the internal angle is an
    approximation. Reads the first four components only (BFoV)."""
    del rbb_angle  # unused by the legacy rules
    t1, p1, a1, b1 = _split(boxes1)
    t2, p2, a2, b2 = _split(boxes2)

    # "convention" frame: longitude in (-pi, pi), latitude in (pi/2, -pi/2)
    lam1, lam2 = t1 - math.pi, t2 - math.pi
    lat1, lat2 = math.pi / 2.0 - p1, math.pi / 2.0 - p2

    # latitudes relative to their midpoint
    lat_mid = (lat1 + lat2) / 2.0
    lat1_, lat2_ = lat1 - lat_mid, lat2 - lat_mid

    # haversine arc length between the two centres
    dlat = (lat1 - lat2).abs()
    dlam = (lam1 - lam2).abs()
    hav = torch.sin(dlat / 2.0) ** 2 \
        + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlam / 2.0) ** 2
    arc = 2.0 * torch.arcsin(torch.sqrt(hav.clamp(0.0, 1.0)))

    # longitude separation on the (near-)equator giving the same arc length
    num = torch.sin(arc / 2.0) ** 2 - torch.sin(dlat / 2.0) ** 2
    den = torch.cos(lat1_) * torch.cos(lat2_)
    ratio = (num / den.clamp_min(1e-12)).clamp(0.0, 1.0)
    dlam_ = (2.0 * torch.arcsin(torch.sqrt(ratio))).abs()
    lam2_sign = torch.where(lam2 > lam1, 1.0, -1.0)

    # approximate internal angles from longitude tangents at the box vs a
    # reference point (same latitude, midpoint longitude)
    t_mid = (t1 + t2) / 2.0

    def legacy_angle(theta_box, phi_box, theta_ref):
        db = longitude_tangent(theta_box, phi_box)
        dr = longitude_tangent(theta_ref, phi_box)
        ang = angle_between(db, dr)
        north = phi_box < math.pi / 2.0
        pos = ((theta_box >= theta_ref) & north) \
            | ((theta_box <= theta_ref) & ~north)
        return torch.where(pos, ang, -ang)

    ang1 = legacy_angle(t1, p1, t_mid)
    ang2 = legacy_angle(t2, p2, t_mid)

    zeros = torch.zeros_like(t1)
    pob1 = torch.stack([zeros, lat1_, _edge_length(a1, rbb_edge),
                        _edge_length(b1, rbb_edge), ang1], dim=-1)
    pob2 = torch.stack([dlam_ * lam2_sign, lat2_, _edge_length(a2, rbb_edge),
                        _edge_length(b2, rbb_edge), ang2], dim=-1)
    return pob1, pob2


TRANSFORMS = {
    "sph2pob_standard": sph2pob_standard,
    "sph2pob_efficient": sph2pob_efficient,
    "sph2pob_legacy": sph2pob_legacy,
}

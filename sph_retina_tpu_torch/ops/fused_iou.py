"""Fused Sph2Pob-IoU pipeline in componentwise form — the plain version.

Degree-space jitter, efficient Sph2Pob transform, rotated-box jitter and the
Green's-theorem rectangle intersection, written over *separate component
tensors* (theta, phi, alpha, beta[, gamma]) instead of stacked ``(..., D)``
boxes:

- the internal rotation angle is never materialised: the clipping only needs
  ``cos(ang)`` and ``sin(ang)``, which fall out of dot/cross products
  (gamma of a rotated box folds in by the angle-subtraction identities);
- the one inverse-trig use — the arc distance between box centres — goes
  through a Cephes-style polynomial atan
  (``arccos(x) = 2 atan(sqrt((1-x)/(1+x)))``, ~1e-7 absolute error).

This module is the plain PyTorch version of the CUDA kernels in
``csrc/sph2pob_iou.cu`` (pairwise) and ``csrc/sph2pob_iou_aligned.cu``
(matched pairs), whose shared per-pair body (``csrc/sph2pob_pair.cuh``)
repeats this arithmetic operation for operation. It is what the CPU tests
hold against the JAX package and what the kernel is held against on the
card, where nothing else calls it but the IoU tool, for its ``fused_plain``
row. ``sph2pob_disjoint_plain`` is the kernels' cull in plain PyTorch: the
pairs it names are those whose IoU is exactly 0.0 and that the kernels skip.

It is written in the kernels' stages: ``jitter_flag`` (the pair's),
``side_state`` (one box in the state the flag selects, with all the
trigonometry), ``disjoint`` (the cull) and ``pair_body`` (the rest).

Shape-polymorphic: ``(N,)`` vectors for matched pairs, or broadcast
``(N, 1)`` x ``(1, M)`` for the pairwise case. fp32 throughout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..iou.rotated import intersection_greens_cs

_EPS = 1e-4 * 1.2345678
_ANG_EPS = 1e-3 * 1.2345678
_COS_EPS = 1e-7
_PI = math.pi
# The cull's margin in radians; csrc/sph2pob_pair.cuh derives it.
_CULL_MARGIN = 2e-3


def _atan_cephes(x):
    """atan for x >= 0: Cephes atanf range reduction + degree-9 polynomial."""
    big = x > 2.414213562373095
    mid = x > 0.4142135623730950
    x_big = -1.0 / torch.where(big, x, 1.0)
    x_mid = (x - 1.0) / (x + 1.0)
    z_in = torch.where(big, x_big, torch.where(mid, x_mid, x))
    y0 = torch.where(big, _PI / 2.0, torch.where(mid, _PI / 4.0, 0.0))
    z = z_in * z_in
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1) * z
         - 3.33329491539e-1) * z * z_in + z_in
    return y0 + p


def arccos_poly(x):
    """arccos on [-1, 1] without an acos primitive; ~1e-7 abs error."""
    x = x.clamp(-1.0 + _COS_EPS, 1.0 - _COS_EPS)
    t = torch.sqrt((1.0 - x) / (1.0 + x))
    return 2.0 * _atan_cephes(t)


def jitter_flag(b1, b2):
    """The pair's degree-space jitter flag: some component of the two boxes
    closer than eps (degrees)."""
    eps = _EPS
    similar = None
    for x, y in zip(b1, b2):
        c = (x - y).abs() < eps
        similar = c if similar is None else (similar | c)
    return similar


def _shift_and_clamp(b, side, similar):
    """One side's degree-space jitter where ``similar`` (box 1 by -2 eps, box
    2 by +eps), then the clamp into the open coordinate ranges."""
    eps = _EPS
    if side == 1:
        vals = [torch.where(similar, x - 2 * eps, x) for x in b]
        lo, hi = 2 * eps, eps
    else:
        vals = [torch.where(similar, x + eps, x) for x in b]
        lo, hi = eps, 2 * eps
    out = [vals[0].clamp(lo, 360.0 - hi)]
    out += [v.clamp(lo, 180.0 - hi) for v in vals[1:4]]
    if len(vals) == 5:
        out.append(vals[4].clamp(-360.0 + lo, 360.0 - hi))
    return out


def _jitter_spherical(b1, b2):
    """Pull near-coincident components of a pair apart (degrees), then clamp
    both boxes into the open coordinate ranges."""
    similar = jitter_flag(b1, b2)
    return _shift_and_clamp(b1, 1, similar), _shift_and_clamp(b2, 2, similar)


class SideState(NamedTuple):
    """What one box contributes to a pair in one jitter state (radians);
    ``cg``, ``sg`` are None for 4-dof boxes."""

    cx: torch.Tensor  # unit centre vector
    cy: torch.Tensor
    cz: torch.Tensor
    dx: torch.Tensor  # longitude tangent
    dy: torch.Tensor
    dz: torch.Tensor
    w: torch.Tensor   # sides
    h: torch.Tensor
    cg: torch.Tensor | None  # cos and sin of gamma
    sg: torch.Tensor | None


def side_state(b, side, similar) -> SideState:
    """Box ``b`` (component tensors in degrees) of ``side`` 1 or 2 in the
    jitter state ``similar`` selects: jitter and clamp, deg -> rad, and all
    the trigonometry of the Sph2Pob transform. Its shape is the broadcast of
    ``b`` and ``similar``: per box for a flag that is a scalar."""
    b = _shift_and_clamp(b, side, similar)
    deg2rad = _PI / 180.0
    b = [v * deg2rad for v in b]
    sp, cp = torch.sin(b[1]), torch.cos(b[1])
    st, ct = torch.sin(b[0]), torch.cos(b[0])
    gamma = len(b) == 5
    return SideState(sp * ct, sp * st, cp, cp * ct, cp * st, -sp, b[2], b[3],
                     torch.cos(b[4]) if gamma else None,
                     torch.sin(b[4]) if gamma else None)


def cull_radius(s: SideState):
    """The radius of the disc about a box's planar rectangle, plus half the
    cull's margin."""
    return 0.5 * torch.sqrt(s.w * s.w + s.h * s.h) + _CULL_MARGIN / 2.0


def disjoint(s1: SideState, r1, s2: SideState, r2):
    """True where the centres lie further apart than r1 + r2: the pair's IoU
    is then exactly 0.0 (the derivation is in ``csrc/sph2pob_pair.cuh``)."""
    r = r1 + r2
    x = r * r
    # 1 - x/2 + x^2/24 - x^3/720 <= cos(sqrt(x)) for every x >= 0
    cos_lb = ((-1.0 / 720.0 * x + 1.0 / 24.0) * x - 0.5) * x + 1.0
    return s1.cx * s2.cx + s1.cy * s2.cy + s1.cz * s2.cz < cos_lb


def _rot_shift(c, s, delta):
    """(cos a, sin a) -> (cos(a+delta), sin(a+delta)) for constant delta."""
    cd, sd = math.cos(delta), math.sin(delta)
    return c * cd - s * sd, s * cd + c * sd


def _jitter_rotated_cs(p1, p2):
    """Rotated-box jitter with angles held as (cos, sin).

    Angle similarity is detected via |sin(a1 - a2)| (fp32-friendly; also
    treats pi-offset angles — identical rectangles — as similar), shifts are
    exact rotations.
    """
    eps = _EPS
    cx1, cy1, w1, h1, c1, s1 = p1
    cx2, cy2, w2, h2, c2, s2 = p2

    sin_diff = (s1 * c2 - c1 * s2).abs()
    similar = (
        ((cx1 - cx2).abs() < eps)
        | ((w1 - w2).abs() < eps)
        | ((h1 - h2).abs() < eps)
        | (sin_diff < eps)
    )
    cx1 = torch.where(similar, cx1 + eps, cx1)
    cy1 = torch.where(similar, cy1 + eps, cy1)
    w1 = torch.where(similar, w1 + 2 * eps, w1)
    h1 = torch.where(similar, h1 + 2 * eps, h1)
    c1s, s1s = _rot_shift(c1, s1, eps)
    c1 = torch.where(similar, c1s, c1)
    s1 = torch.where(similar, s1s, s1)
    cx2 = torch.where(similar, cx2 + 2 * eps, cx2)
    cy2 = torch.where(similar, cy2 + 2 * eps, cy2)
    w2 = torch.where(similar, w2 + eps, w2)
    h2 = torch.where(similar, h2 + eps, h2)
    c2s, s2s = _rot_shift(c2, s2, 5 * eps)
    c2 = torch.where(similar, c2s, c2)
    s2 = torch.where(similar, s2s, s2)

    ang_close = (s1 * c2 - c1 * s2).abs() < _ANG_EPS
    c1s, s1s = _rot_shift(c1, s1, _ANG_EPS)
    c1 = torch.where(ang_close, c1s, c1)
    s1 = torch.where(ang_close, s1s, s1)
    c2s, s2s = _rot_shift(c2, s2, 2 * _ANG_EPS)
    c2 = torch.where(ang_close, c2s, c2)
    s2 = torch.where(ang_close, s2s, s2)

    w1 = w1.clamp_min(2 * eps / 10.0)
    h1 = h1.clamp_min(2 * eps / 10.0)
    w2 = w2.clamp_min(eps / 10.0)
    h2 = h2.clamp_min(eps / 10.0)
    return (cx1, cy1, w1, h1, c1, s1), (cx2, cy2, w2, h2, c2, s2)


def _transform_efficient_cs(s1: SideState, s2: SideState):
    """Componentwise efficient Sph2Pob transform with (cos, sin) angle output,
    from the two boxes' states on.

    Returns two 6-tuples (cx, cy, w, h, cos_ang, sin_ang).
    """
    c1x, c1y, c1z = s1.cx, s1.cy, s1.cz
    c2x, c2y, c2z = s2.cx, s2.cy, s2.cz

    # Frame axis (c1 x c2) and in-plane sign reference (c1 + c2).
    ax = c1y * c2z - c1z * c2y
    ay = c1z * c2x - c1x * c2z
    az = c1x * c2y - c1y * c2x
    rx, ry, rz = c1x + c2x, c1y + c2y, c1z + c2z

    arc = arccos_poly(c1x * c2x + c1y * c2y + c1z * c2z)
    inv_an = torch.rsqrt((ax * ax + ay * ay + az * az).clamp_min(1e-24))

    def angle_cs(dx, dy, dz):
        """cos/sin of the signed angle from the frame axis to tangent d."""
        cos_v = ((dx * ax + dy * ay + dz * az) * inv_an).clamp(
            -1 + _COS_EPS, 1 - _COS_EPS)
        # sign: cross(axis, d) . ref < 0 -> clockwise -> positive angle
        cxd_x = ay * dz - az * dy
        cxd_y = az * dx - ax * dz
        cxd_z = ax * dy - ay * dx
        sign = torch.where(cxd_x * rx + cxd_y * ry + cxd_z * rz < 0, 1.0, -1.0)
        sin_v = sign * torch.sqrt((1.0 - cos_v * cos_v).clamp_min(0.0))
        return cos_v, sin_v

    cos1, sin1 = angle_cs(s1.dx, s1.dy, s1.dz)
    cos2, sin2 = angle_cs(s2.dx, s2.dy, s2.dz)
    if s1.cg is not None and s2.cg is not None:
        # ang -= gamma  (angle-subtraction identities)
        cg1, sg1 = s1.cg, s1.sg
        cos1, sin1 = cos1 * cg1 + sin1 * sg1, sin1 * cg1 - cos1 * sg1
        cg2, sg2 = s2.cg, s2.sg
        cos2, sin2 = cos2 * cg2 + sin2 * sg2, sin2 * cg2 - cos2 * sg2

    zero = torch.zeros_like(arc)
    return (zero, zero, s1.w, s1.h, cos1, sin1), \
        (arc, zero, s2.w, s2.h, cos2, sin2)


def pair_body(s1: SideState, s2: SideState):
    """IoU of a pair from its two states: the transform from the frame axis
    on, the rotated-box jitter, the Green's-theorem intersection, clipped to
    [0, 1]."""
    p1, p2 = _transform_efficient_cs(s1, s2)
    p1, p2 = _jitter_rotated_cs(p1, p2)

    area1 = (p1[2] * p1[3]).abs()
    area2 = (p2[2] * p2[3]).abs()
    # Bound by each box area: the Green's form double-counts boundary runs
    # shared bitwise-exactly, which the jitter above makes improbable but
    # cannot rule out; the clamp keeps any residual case in [0, 1].
    inter = torch.minimum(
        torch.minimum(intersection_greens_cs(p1, p2), area1), area2)
    union = area1 + area2 - inter
    return (inter / union).clamp(0.0, 1.0)


def fused_sph2pob_iou(b1, b2):
    """Degrees-in componentwise fused IoU.

    Args:
        b1, b2: lists/tuples of 4 or 5 broadcast-compatible component tensors
            (theta, phi, alpha, beta[, gamma]) in degrees.
    Returns:
        IoU tensor of the broadcast shape, clipped to [0, 1].
    """
    b1 = [torch.as_tensor(v, dtype=torch.float32) for v in b1]
    b2 = [torch.as_tensor(v, dtype=torch.float32) for v in b2]
    similar = jitter_flag(b1, b2)
    return pair_body(side_state(b1, 1, similar), side_state(b2, 2, similar))


def sph2pob_iou_pairwise_plain(boxes1: torch.Tensor,
                               boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise Sph2Pob IoU: (N, D) x (M, D) degrees -> (N, M) in [0, 1].

    Broadcasts ``(N, 1)`` x ``(1, M)`` components through
    :func:`fused_sph2pob_iou`; every intermediate is an (N, M) tensor, which
    is what the kernel exists to avoid.
    """
    if boxes1.ndim != 2 or boxes2.ndim != 2 \
            or boxes1.shape[1] != boxes2.shape[1] \
            or boxes1.shape[1] not in (4, 5):
        raise ValueError(
            f"expected (N, D) and (M, D) boxes with D in (4, 5), got "
            f"{tuple(boxes1.shape)} and {tuple(boxes2.shape)}")
    d = boxes1.shape[1]
    b1 = [boxes1[:, c].float()[:, None] for c in range(d)]
    b2 = [boxes2[:, c].float()[None, :] for c in range(d)]
    return fused_sph2pob_iou(b1, b2)


def sph2pob_iou_aligned_plain(boxes1: torch.Tensor,
                              boxes2: torch.Tensor) -> torch.Tensor:
    """Aligned Sph2Pob IoU: (N, D), (N, D) degrees -> (N,) in [0, 1].

    :func:`fused_sph2pob_iou` on component vectors of shape ``(N,)``.
    """
    if boxes1.ndim != 2 or boxes1.shape != boxes2.shape \
            or boxes1.shape[1] not in (4, 5):
        raise ValueError(
            f"expected two (N, D) box sets of one shape with D in (4, 5), "
            f"got {tuple(boxes1.shape)} and {tuple(boxes2.shape)}")
    d = boxes1.shape[1]
    return fused_sph2pob_iou([boxes1[:, c].float() for c in range(d)],
                             [boxes2[:, c].float() for c in range(d)])


def sph2pob_disjoint_plain(boxes1: torch.Tensor,
                           boxes2: torch.Tensor) -> torch.Tensor:
    """The kernels' cull: True where a pair's IoU is exactly 0.0 because its
    boxes lie apart.

    ``boxes1`` and ``boxes2`` are ``(..., D)`` degrees whose leading shapes
    broadcast — ``b1[:, None]`` x ``b2[None]`` for the pairwise case, two
    ``(N, D)`` sets for matched pairs. After the degree-space jitter of the
    IoU, a pair is disjoint where its centre vectors' dot product lies below
    a lower bound of ``cos(R1 + R2 + margin)``, ``R = sqrt(w^2 + h^2) / 2``
    the radius of a box's planar rectangle (the derivation is in
    ``csrc/sph2pob_pair.cuh``). Nothing on the main path calls this; the CPU
    tests and ``chip_smoke.py`` (each input's culled share) do.
    """
    d = boxes1.shape[-1]
    if d not in (4, 5) or boxes2.shape[-1] != d:
        raise ValueError(
            f"expected (..., D) boxes with D in (4, 5) on both sides, got "
            f"{tuple(boxes1.shape)} and {tuple(boxes2.shape)}")
    b1 = [boxes1[..., c].float() for c in range(d)]
    b2 = [boxes2[..., c].float() for c in range(d)]
    similar = jitter_flag(b1, b2)
    s1, s2 = side_state(b1, 1, similar), side_state(b2, 2, similar)
    return disjoint(s1, cull_radius(s1), s2, cull_radius(s2))

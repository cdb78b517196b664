"""Frozen plain Sph2Pob IoU: the arithmetic of the fused pairwise kernel K1.

A copy, kept with the benchmark, of the port's plain version of its IoU
kernels (the componentwise fused pipeline and the Green's-theorem rectangle
intersection), taken at the commit that defined the benchmark. It is the
reference's IoU for the max-IoU assignment and the rotated NMS, and its
stages are what the frozen K1 operation counts (``bench_port/k1.py``) were
counted on. Nothing here imports the port; a later change to the port's
kernels or their plain version leaves this file as it is.

Boxes are (theta, phi, alpha, beta[, gamma]) in degrees; fp32 throughout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_EPS = 1e-4 * 1.2345678
_ANG_EPS = 1e-3 * 1.2345678
_COS_EPS = 1e-7
_PI = math.pi
_CULL_MARGIN = 2e-3
_BIG = 1e30
_DIV_EPS = 1e-12


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
    x = x.clamp(-1.0 + _COS_EPS, 1.0 - _COS_EPS)
    return 2.0 * _atan_cephes(torch.sqrt((1.0 - x) / (1.0 + x)))


def jitter_flag(b1, b2):
    """Some component of the two boxes closer than eps (degrees)."""
    similar = None
    for x, y in zip(b1, b2):
        c = (x - y).abs() < _EPS
        similar = c if similar is None else (similar | c)
    return similar


def _shift_and_clamp(b, side, similar):
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


class SideState(NamedTuple):
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    cg: torch.Tensor | None
    sg: torch.Tensor | None


def side_state(b, side, similar) -> SideState:
    """One box in the jitter state ``similar`` selects: jitter, clamp,
    radians and the trigonometry of the Sph2Pob transform."""
    b = _shift_and_clamp(b, side, similar)
    b = [v * (_PI / 180.0) for v in b]
    sp, cp = torch.sin(b[1]), torch.cos(b[1])
    st, ct = torch.sin(b[0]), torch.cos(b[0])
    gamma = len(b) == 5
    return SideState(sp * ct, sp * st, cp, cp * ct, cp * st, -sp, b[2], b[3],
                     torch.cos(b[4]) if gamma else None,
                     torch.sin(b[4]) if gamma else None)


def cull_radius(s: SideState):
    return 0.5 * torch.sqrt(s.w * s.w + s.h * s.h) + _CULL_MARGIN / 2.0


def disjoint(s1: SideState, r1, s2: SideState, r2):
    """True where the centres lie further apart than r1 + r2: IoU 0.0."""
    r = r1 + r2
    x = r * r
    cos_lb = ((-1.0 / 720.0 * x + 1.0 / 24.0) * x - 0.5) * x + 1.0
    return s1.cx * s2.cx + s1.cy * s2.cy + s1.cz * s2.cz < cos_lb


def _rot_shift(c, s, delta):
    cd, sd = math.cos(delta), math.sin(delta)
    return c * cd - s * sd, s * cd + c * sd


def _jitter_rotated_cs(p1, p2):
    eps = _EPS
    cx1, cy1, w1, h1, c1, s1 = p1
    cx2, cy2, w2, h2, c2, s2 = p2
    sin_diff = (s1 * c2 - c1 * s2).abs()
    similar = (((cx1 - cx2).abs() < eps) | ((w1 - w2).abs() < eps)
               | ((h1 - h2).abs() < eps) | (sin_diff < eps))
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
    c1x, c1y, c1z = s1.cx, s1.cy, s1.cz
    c2x, c2y, c2z = s2.cx, s2.cy, s2.cz
    ax = c1y * c2z - c1z * c2y
    ay = c1z * c2x - c1x * c2z
    az = c1x * c2y - c1y * c2x
    rx, ry, rz = c1x + c2x, c1y + c2y, c1z + c2z
    arc = arccos_poly(c1x * c2x + c1y * c2y + c1z * c2z)
    inv_an = torch.rsqrt((ax * ax + ay * ay + az * az).clamp_min(1e-24))

    def angle_cs(dx, dy, dz):
        cos_v = ((dx * ax + dy * ay + dz * az) * inv_an).clamp(
            -1 + _COS_EPS, 1 - _COS_EPS)
        cxd_x = ay * dz - az * dy
        cxd_y = az * dx - ax * dz
        cxd_z = ax * dy - ay * dx
        sign = torch.where(cxd_x * rx + cxd_y * ry + cxd_z * rz < 0, 1.0, -1.0)
        sin_v = sign * torch.sqrt((1.0 - cos_v * cos_v).clamp_min(0.0))
        return cos_v, sin_v

    cos1, sin1 = angle_cs(s1.dx, s1.dy, s1.dz)
    cos2, sin2 = angle_cs(s2.dx, s2.dy, s2.dz)
    if s1.cg is not None and s2.cg is not None:
        cg1, sg1 = s1.cg, s1.sg
        cos1, sin1 = cos1 * cg1 + sin1 * sg1, sin1 * cg1 - cos1 * sg1
        cg2, sg2 = s2.cg, s2.sg
        cos2, sin2 = cos2 * cg2 + sin2 * sg2, sin2 * cg2 - cos2 * sg2
    zero = torch.zeros_like(arc)
    return (zero, zero, s1.w, s1.h, cos1, sin1), \
        (arc, zero, s2.w, s2.h, cos2, sin2)


def _corner_list_cs(cx, cy, w, h, cos, sin):
    hw, hh = w * 0.5, h * 0.5
    pts = []
    for sx, sy in ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0)):
        dx, dy = sx * hw, sy * hh
        pts.append((cx + dx * cos - dy * sin, cy + dx * sin + dy * cos))
    return pts


def _axis_bounds(u0, d0, half):
    mid = d0.abs() <= _DIV_EPS
    inv = 1.0 / torch.where(mid, _DIV_EPS, d0)
    t1 = (half - u0) * inv
    t2 = (-half - u0) * inv
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    feas = u0.abs() <= half
    lo = torch.where(mid, torch.where(feas, -_BIG, _BIG), lo)
    hi = torch.where(mid, torch.where(feas, _BIG, -_BIG), hi)
    return lo, hi


def _edge_sum_greens(corners_w, other):
    cxq, cyq, wq, hq, cq, sq = other
    a, b = wq * 0.5, hq * 0.5
    fx, fy = [], []
    for x, y in corners_w:
        rx, ry = x - cxq, y - cyq
        fx.append(rx * cq + ry * sq)
        fy.append(ry * cq - rx * sq)
    acc = None
    for i in range(4):
        j = (i + 1) % 4
        ux, uy = corners_w[i]
        vx, vy = corners_w[j]
        dxw, dyw = vx - ux, vy - uy
        uxf, uyf = fx[i], fy[i]
        dxf, dyf = fx[j] - uxf, fy[j] - uyf
        lox, hix = _axis_bounds(uxf, dxf, a)
        loy, hiy = _axis_bounds(uyf, dyf, b)
        t_lo = torch.maximum(lox, loy).clamp(0.0, 1.0)
        t_hi = torch.minimum(hix, hiy).clamp_max(1.0)
        t_hi = torch.maximum(t_hi, t_lo)
        px = ux + t_lo * dxw
        py = uy + t_lo * dyw
        qx = ux + t_hi * dxw
        qy = uy + t_hi * dyw
        c = px * qy - py * qx
        acc = c if acc is None else acc + c
    return acc


def intersection_greens_cs(p1, p2):
    c1 = _corner_list_cs(*p1)
    c2 = _corner_list_cs(*p2)
    total = _edge_sum_greens(c1, p2) + _edge_sum_greens(c2, p1)
    return (0.5 * total).clamp_min(0.0)


def pair_body(s1: SideState, s2: SideState):
    """IoU of a pair from its two states, clipped to [0, 1]."""
    p1, p2 = _transform_efficient_cs(s1, s2)
    p1, p2 = _jitter_rotated_cs(p1, p2)
    area1 = (p1[2] * p1[3]).abs()
    area2 = (p2[2] * p2[3]).abs()
    inter = torch.minimum(
        torch.minimum(intersection_greens_cs(p1, p2), area1), area2)
    union = area1 + area2 - inter
    return (inter / union).clamp(0.0, 1.0)


def _components(boxes1, boxes2, pairwise: bool):
    d = boxes1.shape[-1]
    if d not in (4, 5) or boxes2.shape[-1] != d:
        raise ValueError(f"boxes of widths {boxes1.shape[-1]} and "
                         f"{boxes2.shape[-1]}; expected 4 or 5 on both sides")
    if pairwise:
        return ([boxes1[:, c].float()[:, None] for c in range(d)],
                [boxes2[:, c].float()[None, :] for c in range(d)])
    return ([boxes1[..., c].float() for c in range(d)],
            [boxes2[..., c].float() for c in range(d)])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 block: int = 64) -> torch.Tensor:
    """(N, D) x (M, D) degrees -> (N, M) Sph2Pob IoU, ``block`` rows of
    ``boxes1`` at a time so that the (rows, M) intermediates fit."""
    out = torch.empty((boxes1.shape[0], boxes2.shape[0]), dtype=torch.float32,
                      device=boxes1.device)
    for i in range(0, boxes1.shape[0], block):
        b1, b2 = _components(boxes1[i:i + block], boxes2, True)
        similar = jitter_flag(b1, b2)
        out[i:i + block] = pair_body(side_state(b1, 1, similar),
                                     side_state(b2, 2, similar))
    return out


def pairwise_disjoint(boxes1: torch.Tensor, boxes2: torch.Tensor,
                      block: int = 256) -> torch.Tensor:
    """(N, M) bool: the pairs whose IoU the geometry makes exactly 0.0 (the
    boxes' discs lie apart), the cull that the roofline of K1 credits."""
    out = torch.empty((boxes1.shape[0], boxes2.shape[0]), dtype=torch.bool,
                      device=boxes1.device)
    for i in range(0, boxes1.shape[0], block):
        b1, b2 = _components(boxes1[i:i + block], boxes2, True)
        similar = jitter_flag(b1, b2)
        s1, s2 = side_state(b1, 1, similar), side_state(b2, 2, similar)
        out[i:i + block] = disjoint(s1, cull_radius(s1), s2, cull_radius(s2))
    return out

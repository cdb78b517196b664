"""Rotated-rectangle intersection by the Green's-theorem boundary integral.

Each of the 8 box edges clipped against the *other* box is a 1-D
parameter-interval clamp in that box's axis-aligned frame, and the
intersection area is the order-free sum of per-segment shoelace cross terms.
Branch-free elementwise code over separate component tensors, so the
pairwise ``(N, 1)`` x ``(1, M)`` case is the same code as the aligned one.

This is the half of the rotated-IoU module that the fused spherical pipeline
(``ops/fused_iou.py``) and the CUDA kernel body (``csrc/sph2pob_pair.cuh``)
are written from; the two are kept line-for-line comparable.
"""

from __future__ import annotations

import torch

_BIG = 1e30
_DIV_EPS = 1e-12


def _corner_list_cs(cx, cy, w, h, cos, sin):
    """CCW corners from (cos, sin) orientation — no trig."""
    hw, hh = w * 0.5, h * 0.5
    pts = []
    for sx, sy in ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0)):
        dx, dy = sx * hw, sy * hh
        pts.append((cx + dx * cos - dy * sin, cy + dx * sin + dy * cos))
    return pts


def _axis_bounds(u0, d0, half):
    """Parameter interval of ``|u0 + t * d0| <= half``."""
    mid = d0.abs() <= _DIV_EPS
    safe = torch.where(mid, _DIV_EPS, d0)
    inv = 1.0 / safe
    t1 = (half - u0) * inv
    t2 = (-half - u0) * inv
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    # |d| ~ 0: the constraint is t-independent — feasible iff |u| <= half
    feas = u0.abs() <= half
    lo = torch.where(mid, torch.where(feas, -_BIG, _BIG), lo)
    hi = torch.where(mid, torch.where(feas, _BIG, -_BIG), hi)
    return lo, hi


def _edge_sum_greens(corners_w, other):
    """Sum of shoelace cross terms of one box's edges clipped to the other.

    ``corners_w``: 4 CCW world-frame (x, y) corner tuples of box P.
    ``other``: 6-tuple (cx, cy, w, h, cos, sin) of box Q.

    Each directed P edge u->v restricted to Q is a 1-D parameter interval:
    in Q's axis-aligned frame the four half-plane constraints become two
    x-bounds and two y-bounds on t. The segment's contribution to
    (1/2) oint (x dy - y dx) is evaluated on world-frame points, since cross
    products are origin-dependent while t is frame-invariant.
    """
    cxq, cyq, wq, hq, cq, sq = other
    a, b = wq * 0.5, hq * 0.5

    # P corners in Q's frame (rotate by -angle_Q about Q's center).
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
        # Both bounds are clamped into [0, 1] BEFORE the empty-interval
        # collapse: a collapse point far off the segment (t ~ 1e4) would put
        # p == q at O(1e4) coordinates, where a fused multiply-add in
        # px*qy - py*qx leaves O(|p|^2 * eps_f32) residue instead of zero.
        t_lo = torch.maximum(lox, loy).clamp(0.0, 1.0)
        t_hi = torch.minimum(hix, hiy).clamp_max(1.0)
        t_hi = torch.maximum(t_hi, t_lo)  # empty -> zero-length -> ~0

        px = ux + t_lo * dxw
        py = uy + t_lo * dyw
        qx = ux + t_hi * dxw
        qy = uy + t_hi * dyw
        c = px * qy - py * qx
        acc = c if acc is None else acc + c
    return acc


def intersection_greens_cs(p1, p2):
    """Intersection area of two rotated rectangles via the boundary integral.

    area(P cap Q) = (1/2) * [sum over P edges clipped to Q + sum over Q edges
    clipped to P] of cross(start, end): the clipped sub-segments tile the
    boundary of the (convex) intersection exactly once.

    Caveat: a boundary run shared *exactly* (identical boxes, touching grid
    cells) is traversed by both boxes and counted twice. Callers jitter
    degenerate pairs first and bound the result by each box area.

    ``p1``, ``p2``: 6-tuples (cx, cy, w, h, cos, sin) of broadcast-compatible
    tensors.
    """
    c1 = _corner_list_cs(*p1)
    c2 = _corner_list_cs(*p2)
    total = _edge_sum_greens(c1, p2) + _edge_sum_greens(c2, p1)
    return (0.5 * total).clamp_min(0.0)

"""Unbiased (exact) spherical-rectangle IoU, the oracle.

Each boundary of a spherical rectangle is a great-circle arc (every boundary
plane passes through the origin), so each box contributes 4 plane normals
and the intersection is the set of unit vectors inside all 8 half-spaces: a
geodesically convex spherical polygon. Its vertices are box corners and
pairwise boundary-circle intersections that pass an inside-all-8-planes
test.

The candidate set is a fixed 40-element mask (4 + 4 corners, 16 + 16
cross-intersections), and the area is a **centroid fan**: the valid vertices
are sorted by angle around their normalised centroid (inside the region, by
convexity) and the signed l'Huilier triangle areas (atan2 form) summed.
Duplicate vertices and tangency points give zero-area triangles, so no
per-vertex bookkeeping is needed. One fused elementwise computation over the
40-lane candidate axis plus one stable sort; batched and differentiable
where meaningful.

The plane dots are explicit multiply-sums (see ``geometry/boxes.py``): a
TF32 product would break the 1e-6 on-plane tolerance. The pairwise case
materialises (..., 40, 8, 3) fp32 products: 3.8 GB at 1000 x 1000 pairs.

Input boxes are (..., 4|5) in **radians**: (theta, phi, fov_x, fov_y[, gamma]).
"""

from __future__ import annotations

import torch

from ..geometry.boxes import cross, normalize, spherical_box_area

# Inside-plane tolerance: above the ~1e-7 on-plane dot noise of fp32, below
# the smallest genuine inside margin (the JAX package's choice, the midpoint
# of a flat error plateau against an fp64 oracle).
_TOL = 1e-6
_I_IDX = [i for i in range(4) for _ in range(4)]   # plane i of box 1 ...
_J_IDX = [j for _ in range(4) for j in range(4)]   # ... against plane j of 2
# corner i lies on planes (_PAIR_A[i], _PAIR_B[i]): (left, up), (down, left),
# (up, right), (right, down)
_PAIR_A = [0, 3, 2, 1]
_PAIR_B = [2, 0, 1, 3]


def _rodrigues(axis: torch.Tensor, v: torch.Tensor,
               gamma: torch.Tensor) -> torch.Tensor:
    """Rotate v about the unit axis by gamma."""
    cg = torch.cos(gamma)[..., None]
    sg = torch.sin(gamma)[..., None]
    return (v * cg + cross(axis, v) * sg
            + axis * (axis * v).sum(-1, keepdim=True) * (1.0 - cg))


def _box_planes_and_corners(boxes: torch.Tensor):
    """Boundary plane normals (..., 4, 3), ordered [left, right, up, down],
    and corner vertices (..., 4, 3)."""
    theta, phi = boxes[..., 0], boxes[..., 1]
    hx, hy = boxes[..., 2] / 2.0, boxes[..., 3] / 2.0

    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    look = torch.stack([sp * ct, sp * st, cp], dim=-1)
    right = torch.stack([-st, ct, torch.zeros_like(st)], dim=-1)
    up = torch.stack([-cp * ct, -cp * st, sp], dim=-1)

    shx, chx = torch.sin(hx)[..., None], torch.cos(hx)[..., None]
    shy, chy = torch.sin(hy)[..., None], torch.cos(hy)[..., None]
    normals = torch.stack([-chx * right + shx * look,
                           chx * right + shx * look,
                           -chy * up + shy * look,
                           chy * up + shy * look], dim=-2)  # (..., 4, 3)

    if boxes.shape[-1] == 5:
        normals = _rodrigues(look[..., None, :], normals, boxes[..., 4:5])

    corners = normalize(cross(normals[..., _PAIR_A, :],
                              normals[..., _PAIR_B, :]))
    return normals, corners


def _convex_fan_area(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Area of the convex spherical polygon spanned by the valid points.

    ``pts``: (..., K, 3) unit vectors, ``valid``: (..., K) bool. The points
    lie on (the boundary of) one geodesically convex region per batch
    element; duplicates and points inside a boundary arc give zero-area fan
    triangles. 0 where fewer than 3 points are valid.
    """
    k = pts.shape[-2]
    dtype = pts.dtype
    w = valid.to(dtype)[..., None]
    cen = normalize((pts * w).sum(-2))  # inside the region (convexity)

    # tangent frame at the centroid; the reference axis chosen away from it:
    # +z where |cen_z| < 0.9, else +x
    z_far = (cen[..., 2:3].abs() < 0.9).to(dtype)
    axis = torch.cat([1.0 - z_far, torch.zeros_like(z_far), z_far], dim=-1)
    e1 = normalize(cross(cen, axis))
    e2 = cross(cen, e1)

    ang = torch.atan2((pts * e2[..., None, :]).sum(-1),
                      (pts * e1[..., None, :]).sum(-1))
    key = torch.where(valid, ang, 100.0)  # invalid last
    _, order = torch.sort(key, dim=-1, stable=True)
    pts_s = pts.gather(-2, order[..., None].expand(pts.shape))  # CCW

    nv = valid.sum(-1)
    lane = torch.arange(k, device=pts.device)
    # the last valid (sorted) point, by a masked reduction
    one_hot_last = (lane == (nv - 1)[..., None]).to(dtype)[..., None]
    p_last = (pts_s * one_hot_last).sum(-2)
    # padding replaced by p_last: pad triangles vanish and the wrap-around
    # pair (q[K-1], q[0]) becomes the closing (last, first) edge
    is_pad = lane >= nv[..., None]
    q = torch.where(is_pad[..., None], p_last[..., None, :], pts_s)
    qn = torch.cat([q[..., 1:, :], q[..., :1, :]], dim=-2)

    # signed l'Huilier: 2 atan2(cen . (q x qn), 1 + q.qn + cen.q + cen.qn)
    c = cen[..., None, :]
    num = (c * cross(q, qn)).sum(-1)
    den = 1.0 + (q * qn).sum(-1) + (c * q).sum(-1) + (c * qn).sum(-1)
    area = (2.0 * torch.atan2(num, den)).sum(-1)
    return torch.where(nv >= 3, area.clamp_min(0.0), 0.0)


def unbiased_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 eps: float = 1e-8) -> torch.Tensor:
    """Exact spherical IoU, elementwise over matching leading shapes."""
    n1, v1 = _box_planes_and_corners(boxes1)
    n2, v2 = _box_planes_and_corners(boxes2)

    # 40 candidate vertices; for the plane pair (i of box 1, j of box 2)
    # both +-cross directions are candidates
    raw12 = cross(n1[..., _I_IDX, :], n2[..., _J_IDX, :])
    cross12 = normalize(raw12, eps=1e-10)
    cands = torch.cat([v1, v2, cross12, -cross12], dim=-2)  # (..., 40, 3)

    # (near-)parallel plane pairs (a shared side, identical boxes) have
    # |n1 x n2| ~ 0: their eps-normalised "intersection" is a near-zero
    # vector that would pass the inside test as a phantom point; the true
    # vertices on a shared boundary are corner candidates already
    cross_ok = (raw12 * raw12).sum(-1) > 1e-12  # (..., 16)
    corner_ok = torch.ones(v1.shape[:-2] + (8,), dtype=torch.bool,
                           device=v1.device)
    cand_ok = torch.cat([corner_ok, cross_ok, cross_ok], dim=-1)

    # inside all 8 planes, with tolerance
    planes = torch.cat([n1, n2], dim=-2)  # (..., 8, 3)
    dots = (cands[..., :, None, :] * planes[..., None, :, :]).sum(-1)
    inside = (dots >= -_TOL).all(-1) & cand_ok  # (..., 40)

    inter = _convex_fan_area(cands, inside)

    area1 = spherical_box_area(boxes1[..., 2], boxes1[..., 3])
    area2 = spherical_box_area(boxes2[..., 2], boxes2[..., 3])
    # the fan area is exact up to fp32 rounding but independent of the
    # analytic box areas: bound it, so that containment cannot exceed IoU 1
    inter = torch.minimum(inter, torch.minimum(area1, area2))
    return (inter + eps) / (area1 + area2 - inter - eps)

"""Frozen plain Sph2Pob IoU loss geometry: the differentiable path of the
``Sph2PobIoULoss`` that the FCOS configuration trains with.

The spherical pair's jitter, the standard Sph2Pob transform (an explicit
rotation that moves both centres onto the equator), the rotated-box jitter
and the sort-free Sutherland-Hodgman rectangle intersection, in plain
PyTorch, differentiable. Copied, with the benchmark, from the semantics of
the Sph2Pob paper's code as the port had them when the benchmark was
defined; nothing here imports the port.

Spherical boxes are (..., 4|5) degrees; rotated boxes (cx, cy, w, h,
angle_rad).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-4 * 1.2345678
_ANG_EPS = 1e-3 * 1.2345678
_UNIT_EPS = 1e-7
_CLIP_EPS = 1e-12


# ----------------------------------------------------------------- vectors
def _unit_vec(theta, phi):
    s = torch.sin(phi)
    return torch.stack([s * torch.cos(theta), s * torch.sin(theta),
                        torch.cos(phi)], dim=-1)


def _lon_tangent(theta, phi):
    c = torch.cos(phi)
    return torch.stack([c * torch.cos(theta), c * torch.sin(theta),
                        -torch.sin(phi)], dim=-1)


def _normalize(v, eps=1e-12):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True)).clamp_min(eps)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _angle(a, b):
    cos = (_normalize(a) * _normalize(b)).sum(-1)
    return torch.arccos(cos.clamp(-1.0 + _UNIT_EPS, 1.0 - _UNIT_EPS))


def _turn_sign(a, b, ref):
    return torch.where((_cross(a, b) * ref).sum(-1) < 0, 1.0, -1.0).to(a.dtype)


def _basis(like, axis):
    out = torch.zeros_like(like)
    out[..., axis] = 1.0
    return out


def _mat_vec(m, v):
    return (m * v[..., None, :]).sum(-1)


def _mat_mat(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _lookat(theta, phi):
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    zero = torch.zeros_like(theta)
    return torch.stack([torch.stack([sp * ct, sp * st, cp], -1),
                        torch.stack([cp * ct, cp * st, -sp], -1),
                        torch.stack([st, -ct, zero], -1)], dim=-2)


def _rotate_about_radial(theta, phi, gamma):
    t = _lookat(theta, phi)
    sg, cg = torch.sin(gamma), torch.cos(gamma)
    zero, one = torch.zeros_like(gamma), torch.ones_like(gamma)
    rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cg, -sg], -1),
                      torch.stack([zero, sg, cg], -1)], dim=-2)
    return _mat_mat(_mat_mat(t.transpose(-1, -2), rx), t)


# ----------------------------------------------------------------- transform
def sph2pob_standard(boxes1, boxes2, eps: float = 1e-8):
    """(..., 4|5) radians -> two (..., 5) rotated boxes."""
    t1, p1, a1, b1 = (boxes1[..., i] for i in range(4))
    t2, p2, a2, b2 = (boxes2[..., i] for i in range(4))
    c1, c2 = _unit_vec(t1, p1), _unit_vec(t2, p2)
    d1, d2 = _lon_tangent(t1, p1), _lon_tangent(t2, p2)
    if boxes1.shape[-1] == 5:
        d1 = _mat_vec(_rotate_about_radial(t1, p1, -boxes1[..., 4]), d1)
    if boxes2.shape[-1] == 5:
        d2 = _mat_vec(_rotate_about_radial(t2, p2, -boxes2[..., 4]), d2)

    degenerate = (c1 - c2).abs().sum(-1) <= eps
    look = _normalize(c1 + c2)
    right = _normalize(torch.where(degenerate[..., None], _basis(c1, 1),
                                   c2 - c1))
    r_pair = torch.stack([look, right, _cross(look, right)], dim=-2)
    r_mid = _lookat((t1 + t2) / 2.0, (p1 + p2) / 2.0)
    rot = torch.where(degenerate[..., None, None], r_mid, r_pair)
    rc1, rc2 = _mat_vec(rot, c1), _mat_vec(rot, c2)
    rd1, rd2 = _mat_vec(rot, d1), _mat_vec(rot, d2)

    z, x = _basis(rd1, 2), _basis(rd1, 0)
    ang1 = _angle(rd1, z) * _turn_sign(z, rd1, x)
    ang2 = _angle(rd2, z) * _turn_sign(z, rd2, x)

    def signed_coords(v):
        zz, xx = _basis(v, 2), _basis(v, 0)
        phi = _angle(v, zz)
        v_xy = torch.cat([v[..., :2], torch.zeros_like(v[..., 2:])], dim=-1)
        return _angle(v_xy, xx) * _turn_sign(xx, v_xy, -zz), phi

    th1, ph1 = signed_coords(rc1)
    th2, ph2 = signed_coords(rc2)
    return (torch.stack([th1, ph1, a1, b1, ang1], dim=-1),
            torch.stack([th2, ph2, a2, b2, ang2], dim=-1))


# ----------------------------------------------------------------- jitters
def _clamp_cols(boxes, lo, hi):
    return torch.stack([c.clamp(a, b) for c, a, b
                        in zip(boxes.unbind(-1), lo, hi)], dim=-1)


def jitter_spherical(boxes1, boxes2):
    eps = _EPS
    similar = ((boxes1 - boxes2).abs() < eps).any(-1, keepdim=True)
    boxes1 = torch.where(similar, boxes1 - 2.0 * eps, boxes1)
    boxes2 = torch.where(similar, boxes2 + eps, boxes2)
    lo1, hi1 = [2 * eps] * 4, [360.0 - eps] + [180.0 - eps] * 3
    lo2, hi2 = [eps] * 4, [360.0 - 2 * eps] + [180.0 - 2 * eps] * 3
    if boxes1.shape[-1] == 5:
        lo1.append(-360.0 + 2 * eps)
        hi1.append(360.0 - eps)
        lo2.append(-360.0 + eps)
        hi2.append(360.0 - 2 * eps)
    return _clamp_cols(boxes1, lo1, hi1), _clamp_cols(boxes2, lo2, hi2)


def jitter_rotated(pob1, pob2):
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
    close = (a1 - a2).abs() < _ANG_EPS
    a1 = a1 + torch.where(close, _ANG_EPS, 0.0)
    a2 = a2 + torch.where(close, 2.0 * _ANG_EPS, 0.0)
    two_pi = 2.0 * math.pi
    return (torch.stack([x1, y1, w1.clamp_min(2 * eps / 10.0),
                         h1.clamp_min(2 * eps / 10.0),
                         a1.clamp(-two_pi + 2 * eps, two_pi - eps)], -1),
            torch.stack([x2, y2, w2.clamp_min(eps / 10.0),
                         h2.clamp_min(eps / 10.0),
                         a2.clamp(-two_pi + eps, two_pi - 2 * eps)], -1))


# ----------------------------------------------------------------- IoU
def _corners(cx, cy, w, h, ang):
    c, s = torch.cos(ang), torch.sin(ang)
    hw, hh = w * 0.5, h * 0.5
    return [(cx + sx * hw * c - sy * hh * s, cy + sx * hw * s + sy * hh * c)
            for sx, sy in ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0),
                           (1.0, -1.0))]


def _clip(pts, ax, ay, bx, by):
    """Clip by the half-plane left of a->b; every edge emits two points."""
    dx, dy = bx - ax, by - ay
    inv_dd = 1.0 / (dx * dx + dy * dy).clamp_min(_CLIP_EPS)
    sides = [dx * (py - ay) - dy * (px - ax) for px, py in pts]
    out = []
    n = len(pts)
    for i in range(n):
        (cx, cy), sc = pts[i], sides[i]
        (nx, ny), sn = pts[(i + 1) % n], sides[(i + 1) % n]
        den = sc - sn
        den = torch.where(den.abs() < _CLIP_EPS, _CLIP_EPS, den)
        t = sc / den
        ix, iy = cx + t * (nx - cx), cy + t * (ny - cy)
        pcx, pcy = cx + sc * dy * inv_dd, cy - sc * dx * inv_dd
        pnx, pny = nx + sn * dy * inv_dd, ny - sn * dx * inv_dd
        cin, nin = sc >= 0.0, sn >= 0.0
        out.append((torch.where(cin, cx, torch.where(nin, ix, pcx)),
                    torch.where(cin, cy, torch.where(nin, iy, pcy))))
        out.append((torch.where(nin, nx, torch.where(cin, ix, pnx)),
                    torch.where(nin, ny, torch.where(cin, iy, pny))))
    return out


def rotated_iou(pob1, pob2):
    """Elementwise IoU of rotated boxes (..., 5) -> (...); differentiable."""
    comps = torch.broadcast_tensors(*pob1.unbind(-1), *pob2.unbind(-1))
    b1, b2 = comps[:5], comps[5:]
    poly, clip = _corners(*b1), _corners(*b2)
    for k in range(4):
        (ax, ay), (bx, by) = clip[k], clip[(k + 1) % 4]
        poly = _clip(poly, ax, ay, bx, by)
    total = None
    for i in range(len(poly)):
        x0, y0 = poly[i]
        x1, y1 = poly[(i + 1) % len(poly)]
        c = x0 * y1 - y0 * x1
        total = c if total is None else total + c
    inter = (0.5 * total).clamp_min(0.0)
    area1, area2 = (b1[2] * b1[3]).abs(), (b2[2] * b2[3]).abs()
    union = area1 + area2 - inter
    ok = union > 0.0
    return torch.where(ok, inter / torch.where(ok, union, 1.0), 0.0)


def sph2pob_iou_loss_terms(pred_deg, target_deg):
    """Per-box ``1 - IoU`` of the Sph2Pob-transformed pair (``mode='iou'``)."""
    p, t = jitter_spherical(pred_deg, target_deg)
    pob_p, pob_t = sph2pob_standard(torch.deg2rad(p), torch.deg2rad(t))
    pob_p, pob_t = jitter_rotated(pob_p, pob_t)
    return 1.0 - rotated_iou(pob_p, pob_t).clamp(0.0, 1.0)

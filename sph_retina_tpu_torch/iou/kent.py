"""Kent (Fisher-Bingham FB5) distribution subsystem in plain PyTorch.

Spherical boxes modelled as Kent distributions on S^2 and compared by KL
divergence; everything is closed-form, batched and differentiable on the
boxes' device:

- ``deg2kent``: BFoV box -> Kent parameters by moment estimation over a
  fixed 11x11 tangent-grid sample. The ERP-pixel round trip of the original
  code base collapses to a sign permutation (X = (-p_y, -p_z, -p_x)), and
  the 2x2 eigendecomposition is closed-form (half-angle atan2).
- ``kent_kld``: closed-form KL divergence with every normalizer ratio
  computed analytically, so nothing exponentiates kappa (which would
  overflow fp32 at kappa > 88).

Canonical parameter layout: ``(kappa, beta, alpha, psi, eta)``, the mean
direction being gamma1 = (cos(alpha), sin(alpha) cos(eta), sin(alpha)
sin(eta)).

Precision: fp32 throughout, whatever the network's dtype; 3-vector and 3x3
products are multiply-sums, never ``matmul`` (a TF32 product on the card
would move the moment frame). Every clamp, floor and double-``where`` below
keeps a NaN out of the value or the gradient at a degenerate box (a pole, a
180-degree FoV, an isotropic box, an identical pair) and is copied from the
JAX package exactly.
"""

from __future__ import annotations

import math

import torch

MIN_KAPPA = 1e-6
_EPS = 1e-12
_GRID = 11  # the tangent grid is _GRID x _GRID points


# --------------------------------------------------------------------------- #
# angles <-> orthonormal frame
# --------------------------------------------------------------------------- #
def kent_angles_to_gammas(alpha, psi, eta):
    """(alpha, psi, eta) -> (gamma1, gamma2, gamma3), each (..., 3)."""
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cp, sp = torch.cos(psi), torch.sin(psi)
    ce, se = torch.cos(eta), torch.sin(eta)
    g1 = torch.stack([ca, sa * ce, sa * se], dim=-1)
    g2 = torch.stack(
        [-cp * sa, cp * ca * ce - sp * se, cp * ca * se + sp * ce], dim=-1)
    g3 = torch.stack(
        [sp * sa, -sp * ca * ce - cp * se, -sp * ca * se + cp * ce], dim=-1)
    return g1, g2, g3


def _dot(u, v):
    return (u * v).sum(dim=-1)


# --------------------------------------------------------------------------- #
# deg2kent: moment estimation over the 11x11 tangent grid
# --------------------------------------------------------------------------- #
def _sample_box_points(boxes_rad: torch.Tensor) -> torch.Tensor:
    """(..., 4|5) radians -> (..., 121, 3) unit-sphere samples.

    A tangent grid scaled by the FoVs, rotated to the box centre with
    Ry(lon) Rx(lat). A 5th column (RBFoV gamma) rolls the grid about the
    boresight before lifting, so the Kent backend sees the box's rotation.
    """
    lon = boxes_rad[..., 0] - math.pi
    # Keep the centre strictly off the poles: at phi = 0 or pi the mean
    # direction hits alpha = 0/pi, where arccos has an infinite gradient and
    # eta = atan2(0, 0) NaNs the backward pass (decoded boxes land on the
    # [0, 180] phi clamp early in training). 1e-2 rad bounds the arccos
    # gradient at ~1e2.
    lat = torch.clamp(boxes_rad[..., 1] - math.pi / 2.0,
                      -(math.pi / 2.0 - 1e-2), math.pi / 2.0 - 1e-2)
    # Keep the FoVs strictly inside (0, pi): tan(fov/2) has its pole at pi
    # and its zero at 0, and decoded boxes land on the 180-degree clamp.
    fov_h = torch.clamp(boxes_rad[..., 2], 1e-3, math.pi - 1e-2)
    fov_v = torch.clamp(boxes_rad[..., 3], 1e-3, math.pi - 1e-2)

    # the grid's offsets, i down the rows and j along them, made on the
    # boxes' device (no host-to-device copy)
    idx = torch.arange(-(_GRID // 2), _GRID // 2 + 1, dtype=torch.float32,
                       device=boxes_rad.device)
    ii = idx.repeat_interleave(_GRID)  # (121,)
    jj = idx.repeat(_GRID)

    d_lat = _GRID / (2.0 * torch.tan(fov_v / 2.0))
    d_long = _GRID / (2.0 * torch.tan(fov_h / 2.0))
    # p = (i * d_lat/d_long, j, d_lat), normalised
    px = ii * (d_lat / d_long)[..., None]
    py = jj * torch.ones_like(d_lat)[..., None]
    pz = d_lat[..., None] * torch.ones_like(jj)
    if boxes_rad.shape[-1] == 5:
        gamma = boxes_rad[..., 4:5]
        cg, sg = torch.cos(gamma), torch.sin(gamma)
        px, py = px * cg - py * sg, px * sg + py * cg
    inv = torch.rsqrt(px * px + py * py + pz * pz)
    px, py, pz = px * inv, py * inv, pz * inv

    # R = Ry(lon) @ Rx(lat); rotate p
    cl, sl = torch.cos(lon)[..., None], torch.sin(lon)[..., None]
    ct, st = torch.cos(lat)[..., None], torch.sin(lat)[..., None]
    # Rx(lat): (x, y cos - z sin, y sin + z cos)
    qx, qy, qz = px, py * ct - pz * st, py * st + pz * ct
    # Ry(lon): (x cos + z sin, y, -x sin + z cos)
    rx = qx * cl + qz * sl
    ry = qy
    rz = -qx * sl + qz * cl
    # the ERP round trip is a sign permutation
    return torch.stack([-ry, -rz, -rx], dim=-1)  # (..., 121, 3)


def _kent_moments(boxes_rad: torch.Tensor):
    """Sample moments of the tangent grid: (r1, r2, alpha, psi, eta).

    r1 = |mean resultant|, r2 = t22 - t33 in the moment frame."""
    xs = _sample_box_points(boxes_rad)  # (..., K, 3)

    xbar = xs.mean(dim=-2)  # (..., 3)
    scatter = (xs[..., :, None] * xs[..., None, :]).mean(dim=-3)  # (..., 3, 3)

    r1 = torch.sqrt(_dot(xbar, xbar))
    g1 = xbar / r1[..., None].clamp_min(_EPS)

    # arccos'(x) = -1/sqrt(1-x^2) is infinite at +-1; the 1e-7 margin
    # bounds the gradient (~2e3) without moving any non-degenerate frame
    alpha = torch.arccos(torch.clamp(g1[..., 0], -1.0 + 1e-7, 1.0 - 1e-7))
    eta = torch.atan2(g1[..., 2], g1[..., 1])

    # H frame, rows of H^T
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    ce, se = torch.cos(eta), torch.sin(eta)
    h2 = torch.stack([-sa, ca * ce, ca * se], dim=-1)
    h3 = torch.stack([torch.zeros_like(ca), -se, ce], dim=-1)

    def quad(u, v):
        return (u[..., :, None] * scatter * v[..., None, :]).sum(dim=(-2, -1))

    # B = H^T S H restricted to the (h2, h3) plane
    b22 = quad(h2, h2)
    b23 = quad(h2, h3)
    b33 = quad(h3, h3)

    # 2x2 symmetric eigen: major axis at half-angle psi. For an ISOTROPIC
    # box (fov_x == fov_y) both atan2 arguments are ~0 and atan2(0, 0) has
    # a NaN gradient; psi is arbitrary there (beta ~ 0), so it is pinned to
    # 0 with the double-where that keeps NaN out of the untaken branch's
    # gradient.
    num = 2.0 * b23
    den = b22 - b33
    degenerate = (num.abs() + den.abs()) < 1e-10
    psi = torch.where(
        degenerate, 0.0,
        0.5 * torch.atan2(torch.where(degenerate, 0.0, num),
                          torch.where(degenerate, 1.0, den)))
    cp, sp = torch.cos(psi), torch.sin(psi)
    # gamma2/3 = H @ (0, cos psi, sin psi) / (0, -sin psi, cos psi)
    g2 = cp[..., None] * h2 + sp[..., None] * h3
    g3 = -sp[..., None] * h2 + cp[..., None] * h3

    r2 = quad(g2, g2) - quad(g3, g3)
    return r1, r2, alpha, psi, eta


def _moment_kappa_beta(r1, r2):
    denom_m = (2.0 - 2.0 * r1 - r2).clamp_min(1e-6)
    denom_p = (2.0 - 2.0 * r1 + r2).clamp_min(1e-6)
    kappa = (1.0 / denom_m + 1.0 / denom_p).clamp_min(MIN_KAPPA)
    beta = 0.5 * (1.0 / denom_m - 1.0 / denom_p)
    return kappa, beta


def deg2kent(boxes_deg: torch.Tensor, img_size=None) -> torch.Tensor:
    """BFoV degrees (..., 4|5) -> Kent params (..., 5) (kappa, beta, alpha,
    psi, eta) by moment estimation. ``img_size`` is accepted for the original
    API; the projection does not depend on the resolution."""
    del img_size
    boxes_rad = torch.deg2rad(torch.as_tensor(boxes_deg).float()[..., :5])
    r1, r2, alpha, psi, eta = _kent_moments(boxes_rad)
    kappa, beta = _moment_kappa_beta(r1, r2)
    return torch.stack([kappa, beta, alpha, psi, eta], dim=-1)


def kent_mle(boxes_deg: torch.Tensor, iters: int = 25) -> torch.Tensor:
    """BFoV degrees (..., 4|5) -> Kent params (..., 5) by maximum likelihood.

    With the moment frame fixed, the asymptotic normalizer log c = log 2pi +
    kappa - 0.5 log(kappa^2 - 4 beta^2) turns the score equations into

        d log c / d kappa = 1 - kappa/d = r1,     d = kappa^2 - 4 beta^2
        d log c / d beta  = 4 beta / d  = r2,

    solved by ``iters`` steps of a 2x2 Newton from the moment estimate:
    closed-form Jacobian, batched, differentiable.
    """
    boxes_rad = torch.deg2rad(torch.as_tensor(boxes_deg).float()[..., :5])
    r1, r2, alpha, psi, eta = _kent_moments(boxes_rad)
    k, b = _moment_kappa_beta(r1, r2)
    for _ in range(iters):
        d = (k * k - 4.0 * b * b).clamp_min(1e-6)
        f1 = 1.0 - k / d - r1
        f2 = 4.0 * b / d - r2
        j11 = (k * k + 4.0 * b * b) / (d * d)       # dF1/dk
        j12 = -8.0 * k * b / (d * d)                # dF1/db
        j21 = j12                                   # dF2/dk (symmetric)
        j22 = (4.0 * k * k + 16.0 * b * b) / (d * d)
        det = j11 * j22 - j12 * j21
        det = torch.where(det.abs() < 1e-12, 1e-12, det)
        dk = (j22 * f1 - j12 * f2) / det
        db = (j11 * f2 - j21 * f1) / det
        k = (k - dk).clamp_min(MIN_KAPPA)
        b = torch.clamp(b - db, torch.zeros_like(k), (k - 1e-3) / 2.0)
    return torch.stack([k, b, alpha, psi, eta], dim=-1)


# --------------------------------------------------------------------------- #
# KLD between Kent distributions
# --------------------------------------------------------------------------- #
def _normalizer_ratios(kappa, beta):
    """Analytic (c_k/c, c_kk/c, c_beta/c), overflow-free."""
    d = (kappa * kappa - 4.0 * beta * beta).clamp_min(1e-6)
    ck_c = (kappa * kappa - kappa - 4.0 * beta * beta) / d
    ckk_c = (
        kappa ** 4 - 2.0 * kappa ** 3 + (2.0 - 8.0 * beta * beta) * kappa * kappa
        + 8.0 * beta * beta * kappa + 16.0 * beta ** 4 + 4.0 * beta * beta
    ) / (d * d)
    cb_c = 4.0 * beta / d
    return ck_c, ckk_c, cb_c


def kent_kld(kent_a: torch.Tensor, kent_b: torch.Tensor) -> torch.Tensor:
    """KL(a || b) elementwise over (..., 5) canonical Kent params (the two
    broadcast against each other)."""
    ka, ba = kent_a[..., 0], kent_a[..., 1]
    kb, bb = kent_b[..., 0], kent_b[..., 1]
    ga1, ga2, ga3 = kent_angles_to_gammas(
        kent_a[..., 2], kent_a[..., 3], kent_a[..., 4])
    gb1, gb2, gb3 = kent_angles_to_gammas(
        kent_b[..., 2], kent_b[..., 3], kent_b[..., 4])

    ck_c, ckk_c, cb_c = _normalizer_ratios(ka, ba)
    lam1 = ck_c
    lam2 = (1.0 - ckk_c + cb_c) / 2.0
    lam3 = (1.0 - ckk_c - cb_c) / 2.0

    # log(c_b / c_a), computed in log space
    da = (ka * ka - 4.0 * ba * ba).clamp_min(1e-6)
    db = (kb * kb - 4.0 * bb * bb).clamp_min(1e-6)
    log_term = (kb - ka) - 0.5 * (torch.log(db) - torch.log(da))

    # E[x]_a = (c_k/c) gamma_a1 ;  (kappa_a g_a1 - kappa_b g_b1) . E[x]_a
    ex = lam1[..., None] * ga1
    kappa_term = _dot(ka[..., None] * ga1 - kb[..., None] * gb1, ex)

    # v^T ExxT v with ExxT = sum_i lam_i g_ai g_ai^T
    def quad_exxt(v):
        return (lam1 * _dot(v, ga1) ** 2 + lam2 * _dot(v, ga2) ** 2
                + lam3 * _dot(v, ga3) ** 2)

    beta_terms = (ba * quad_exxt(ga2) - bb * quad_exxt(gb2)
                  - ba * quad_exxt(ga3) + bb * quad_exxt(gb3))
    return log_term + kappa_term + beta_terms


def kent_iou_from_params(kent_a, kent_b):
    """IoU surrogate 1 / (1 + sqrt(KLD)) of Kent parameters."""
    # the floor keeps sqrt off 0, where its gradient is infinite (identical
    # pairs otherwise NaN the backward pass); value shift < 1e-6
    kld = kent_kld(kent_a, kent_b).clamp_min(1e-12)
    return 1.0 / (1.0 + torch.sqrt(kld))


def kent_iou_elementwise(boxes1_deg, boxes2_deg):
    """IoU surrogate 1 / (1 + sqrt(KLD)) of BFoV degree boxes."""
    return kent_iou_from_params(deg2kent(boxes1_deg), deg2kent(boxes2_deg))


def kent_loss_terms(kent_a, kent_b, const: float = 2.0):
    """1 - 1 / (const + sqrt(KLD)), the KLD floored at 1e-12: sqrt has an
    infinite gradient at 0, and identical pred/target rows (exact-fit
    positives, masked padding) are reachable in training."""
    kld = kent_kld(kent_a, kent_b).clamp_min(1e-12)
    return 1.0 - 1.0 / (const + torch.sqrt(kld))


def sph_kent_loss(pred, target, weight=None, *, const: float = 2.0,
                  reduction: str = "mean", avg_factor=None,
                  loss_weight: float = 1.0):
    """Kent KLD loss over spherical degree boxes (``KentLoss``).

    Zero-weight rows (padded or negative anchors in the positive-gather
    batch) are replaced by a benign box BEFORE ``deg2kent``: ``0 * nan`` is
    nan, so masking the output would not stop a degenerate row from
    poisoning the reduction (and ``where`` would still leak NaN through the
    gradient of the untaken branch)."""
    from ..losses.utils import reduce_box_weight, weight_reduce_loss

    weight = reduce_box_weight(weight)
    if weight is not None:
        safe = torch.zeros_like(pred)  # (180, 90, 30, 30[, 0]), no copy
        safe[..., 0] = 180.0
        safe[..., 1] = 90.0
        safe[..., 2:4] = 30.0
        live = (weight > 0)[..., None]
        pred = torch.where(live, pred, safe)
        target = torch.where(live, target, safe)
    loss = kent_loss_terms(deg2kent(pred), deg2kent(target), const)
    return loss_weight * weight_reduce_loss(loss, weight, reduction, avg_factor)

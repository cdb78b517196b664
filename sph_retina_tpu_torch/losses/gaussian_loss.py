"""Gaussian-modelled rotated-box losses: GWD, KLD, KFIoU, in plain PyTorch.

Each is written from its paper and applied after the Sph2Pob transform:

- GWD: "Rethinking Rotated Object Detection with Gaussian Wasserstein
  Distance Loss" (ICML'21): W2^2 closed form for 2-D Gaussians.
- KLD: "Learning High-Precision Bounding Box for Rotated Object Detection
  via Kullback-Leibler Divergence" (NeurIPS'21).
- KFIoU: "The KFIoU Loss for Rotated Object Detection" (ICLR'23): overlap of
  the Gaussian product ("Kalman filter" fusion).

A rotated box (cx, cy, w, h, a) maps to N(mu, Sigma) with mu = (cx, cy),
Sigma = R diag(w^2/4, h^2/4) R^T. All 2x2 algebra is explicit scalar math
(det / trace / inverse), no ``torch.linalg``; differentiable, on the boxes'
device, fp32.
"""

from __future__ import annotations

import torch

from .sph2pob_loss import sph2pob_pairs
from .utils import reduce_box_weight, weight_reduce_loss


def obb2gaussian(boxes: torch.Tensor):
    """(..., 5) rotated boxes -> (mu (..., 2), sigma components a11, a12,
    a22)."""
    cx, cy, w, h, ang = (boxes[..., i] for i in range(5))
    w = w.clamp(1e-7, 1e7)
    h = h.clamp(1e-7, 1e7)
    cos, sin = torch.cos(ang), torch.sin(ang)
    vx, vy = w * w / 4.0, h * h / 4.0
    a11 = vx * cos * cos + vy * sin * sin
    a12 = (vx - vy) * sin * cos
    a22 = vx * sin * sin + vy * cos * cos
    return torch.stack([cx, cy], dim=-1), (a11, a12, a22)


def _postprocess(distance, fun: str, tau: float):
    """Distance -> loss mapping shared by GWD and KLD (the papers'
    normaliser)."""
    if fun == "log1p":
        distance = torch.log1p(distance)
    elif fun == "sqrt":
        distance = torch.sqrt(distance.clamp_min(1e-7))
    elif fun != "none":
        raise ValueError(f"unsupported fun {fun!r}")
    if tau >= 1.0:
        return 1.0 - 1.0 / (tau + distance)
    return distance


def gwd_terms(pred, target, fun="log1p", tau=1.0, alpha=1.0, normalize=True):
    """Squared 2-Wasserstein distance loss between box Gaussians."""
    mu_p, (p11, p12, p22) = obb2gaussian(pred)
    mu_t, (t11, t12, t22) = obb2gaussian(target)

    xy_dist = ((mu_p - mu_t) ** 2).sum(dim=-1)
    tr_p = p11 + p22
    tr_t = t11 + t22
    det_p = p11 * p22 - p12 * p12
    det_t = t11 * t22 - t12 * t12
    # Tr[(Sp^1/2 St Sp^1/2)^1/2] = sqrt(Tr(Sp St) + 2 sqrt(det Sp det St))
    tr_pt = p11 * t11 + 2.0 * p12 * t12 + p22 * t22
    det_sqrt = torch.sqrt((det_p * det_t).clamp_min(0.0))
    whr_dist = tr_p + tr_t - 2.0 * torch.sqrt(
        (tr_pt + 2.0 * det_sqrt).clamp_min(0.0))
    dist = (xy_dist + alpha * alpha * whr_dist).clamp_min(1e-6)
    if normalize:
        scale = 2.0 * torch.sqrt(torch.sqrt(det_sqrt.clamp_min(1e-7))
                                 ).clamp_min(1e-7)
        dist = dist / scale
    return _postprocess(dist, fun, tau)


def kld_terms(pred, target, fun="log1p", tau=1.0, sqrt=True):
    """KL(pred || target) between box Gaussians."""
    mu_p, (p11, p12, p22) = obb2gaussian(pred)
    mu_t, (t11, t12, t22) = obb2gaussian(target)

    det_p = (p11 * p22 - p12 * p12).clamp_min(1e-7)
    det_t = (t11 * t22 - t12 * t12).clamp_min(1e-7)
    # inverse of the target's sigma
    i11, i12, i22 = t22 / det_t, -t12 / det_t, t11 / det_t
    d = mu_p - mu_t
    maha = (i11 * d[..., 0] ** 2 + 2.0 * i12 * d[..., 0] * d[..., 1]
            + i22 * d[..., 1] ** 2)
    trace = i11 * p11 + 2.0 * i12 * p12 + i22 * p22
    kl = 0.5 * (maha + trace - 2.0 + torch.log(det_t / det_p))
    kl = kl.clamp_min(0.0)
    if sqrt:
        kl = torch.sqrt(kl)
    return _postprocess(kl, fun, tau)


def kfiou_terms(pred, target, fun="none"):
    """KFIoU loss: Gaussian-product overlap ratio.

    V(Sigma) = 4 sqrt(det Sigma) (area of the 1-sigma box surrogate); the
    product Gaussian has Sigma_i = Sp (Sp + St)^-1 St.
    """
    _, (p11, p12, p22) = obb2gaussian(pred)
    _, (t11, t12, t22) = obb2gaussian(target)
    det_p = (p11 * p22 - p12 * p12).clamp_min(1e-7)
    det_t = (t11 * t22 - t12 * t12).clamp_min(1e-7)
    s11, s12, s22 = p11 + t11, p12 + t12, p22 + t22
    det_s = (s11 * s22 - s12 * s12).clamp_min(1e-7)
    # det(Sp (Sp+St)^-1 St) = det_p * det_t / det_s
    det_i = det_p * det_t / det_s
    v_p = 4.0 * torch.sqrt(det_p)
    v_t = 4.0 * torch.sqrt(det_t)
    v_i = 4.0 * torch.sqrt(det_i)
    kfiou = v_i / (v_p + v_t - v_i).clamp_min(1e-7)
    # KFIoU's attainable maximum is 1/3 (identical boxes); rescaled as in
    # the paper
    kfiou = 3.0 * kfiou
    if fun == "ln":
        return -torch.log(kfiou.clamp_min(1e-7))
    if fun == "exp":
        return torch.exp(1.0 - kfiou) - 1.0
    return 1.0 - kfiou.clamp(0.0, 1.0)


def _sph_wrapper(terms_fn):
    def loss_fn(pred, target, weight=None, *, transform="sph2pob_standard",
                reduction="mean", avg_factor=None, loss_weight: float = 1.0,
                center_weight: float = 0.0, **kwargs):
        pob_p, pob_t = sph2pob_pairs(pred, target, transform)
        loss = terms_fn(pob_p, pob_t, **kwargs)
        if center_weight:
            loss = loss + center_weight * (
                pob_p[..., :2] - pob_t[..., :2]).abs().sum(dim=-1)
        weight = reduce_box_weight(weight)
        return loss_weight * weight_reduce_loss(loss, weight, reduction,
                                                avg_factor)
    return loss_fn


sph2pob_gwd_loss = _sph_wrapper(gwd_terms)
sph2pob_kld_loss = _sph_wrapper(kld_terms)
sph2pob_kf_loss = _sph_wrapper(kfiou_terms)

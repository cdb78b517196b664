"""Kent-distribution visualisation on the ERP chart.

- ``kent_density_erp``: the exact density rasterised on the ERP lat-long
  grid, quadrature-normalised so that it integrates to 1 over the sphere
  (or scaled to a maximum of 1 for display);
- ``sample_kent``: samples from the large-kappa Gaussian limit of the Kent
  density, exp(-(kappa/2 - beta) u^2 - (kappa/2 + beta) v^2) in the
  (gamma2, gamma3) tangent plane, lifted back to the sphere;
- ``plot_kent_density``: the density's ``inferno`` heat map, an optional
  ERP background and samples, drawn by ``canvas.py``; it returns the
  rendered (H, W, 3) uint8 array.

Parameters are ``(kappa, beta, alpha, psi, eta)`` (``iou/kent.py``). Sphere
<-> ERP: ``X = (-cos(phi), sin(phi) cos(theta), sin(phi) sin(theta))``,
theta in [0, 360) and phi in [0, 180) degrees.

The density is computed as float64 tensors on ``device`` (``None``: the
CUDA device). Three parts are the host's, so that they are the JAX
package's numbers: the grid's float32 directions (numpy's float32
trigonometry, which the density scales by kappa), the frame of one
parameter vector (the C library's cosines and sines, as numpy's), and the
samples of ``sample_kent`` (numpy's ``default_rng(seed)`` and its float64
lift, a few thousand numbers; PyTorch's CPU square root is not correctly
rounded), which are then moved to ``device``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device
from .canvas import Axes


def _frame(ca, sa, cp, sp, ce, se):
    """(gamma1, gamma2, gamma3) from the cosines and sines of alpha, psi,
    eta."""
    g1 = (ca, sa * ce, sa * se)
    g2 = (-cp * sa, cp * ca * ce - sp * se, cp * ca * se + sp * ce)
    g3 = (sp * sa, -sp * ca * ce - cp * se, -sp * ca * se + cp * ce)
    return g1, g2, g3


def kent_angles_to_gammas(alpha, psi, eta, device=None):
    """(alpha, psi, eta) -> (gamma1, gamma2, gamma3), each (..., 3) float64
    on ``device`` (``None``: the CUDA device)."""
    device = resolve_device(device)
    alpha, psi, eta = (torch.as_tensor(v, dtype=torch.float64).to(device)
                       for v in (alpha, psi, eta))
    trig = (torch.cos(alpha), torch.sin(alpha), torch.cos(psi),
            torch.sin(psi), torch.cos(eta), torch.sin(eta))
    return tuple(torch.stack(g, dim=-1) for g in _frame(*trig))


def _params(params):
    """kappa, beta as floats and the frame as three (3,) float64 arrays."""
    p = torch.as_tensor(params, dtype=torch.float64).reshape(5).tolist()
    trig = [f(a) for a in p[2:5] for f in (math.cos, math.sin)]
    return p[0], p[1], [np.asarray(g, np.float64) for g in _frame(*trig)]


def erp_grid_directions(img_size=(256, 512), device=None) -> torch.Tensor:
    """Unit directions of every ERP pixel centre -> (H, W, 3) float32."""
    h, w = img_size
    theta = (np.arange(w, dtype=np.float32) + 0.5) * (2.0 * np.pi / w)
    phi = (np.arange(h, dtype=np.float32) + 0.5) * (np.pi / h)
    tt, pp = np.meshgrid(theta, phi)
    grid = np.stack([-np.cos(pp), np.sin(pp) * np.cos(tt),
                     np.sin(pp) * np.sin(tt)], axis=-1)
    return torch.from_numpy(grid).to(resolve_device(device))


def directions_to_erp_deg(x):
    """(..., 3) unit directions -> (theta_deg, phi_deg) on the ERP chart,
    on the directions' device."""
    x = torch.as_tensor(x)
    phi = torch.rad2deg(torch.arccos((-x[..., 0]).clamp(-1.0, 1.0)))
    theta = torch.remainder(torch.rad2deg(torch.atan2(x[..., 2], x[..., 1])),
                            360.0)
    return theta, phi


def _dot(x, g):
    return x[..., 0] * g[0] + x[..., 1] * g[1] + x[..., 2] * g[2]


def kent_density_erp(params, img_size=(256, 512), normalize=True,
                     device=None) -> torch.Tensor:
    """Exact Kent density on the ERP grid -> (H, W) float64.

    ``normalize=True`` divides by the sphere quadrature (pixel solid angle
    sin(phi) dtheta dphi) so that the raster integrates to ~1; otherwise the
    density is scaled to a maximum of 1. Computed in log space with its
    maximum subtracted, so that large kappa cannot overflow.
    """
    device = resolve_device(device)
    kappa, beta, frame = _params(params)
    g1, g2, g3 = (torch.from_numpy(g).to(device) for g in frame)
    x = erp_grid_directions(img_size, device).double()
    log_f = kappa * _dot(x, g1) + beta * (_dot(x, g2) ** 2 - _dot(x, g3) ** 2)
    f = torch.exp(log_f - log_f.max())
    if not normalize:
        return f
    h, w = img_size
    phi = (torch.arange(h, dtype=torch.float64, device=device) + 0.5) \
        * (math.pi / h)
    d_omega = torch.sin(phi)[:, None] * (2.0 * math.pi / w) * (math.pi / h)
    return f / (f * d_omega).sum()


def sample_kent(params, n=1000, seed=0, device=None) -> torch.Tensor:
    """~Kent samples -> (n, 3) float64 unit vectors.

    In the tangent plane at gamma1 the Kent density is asymptotically
    N(0, diag(1/(kappa - 2 beta), 1/(kappa + 2 beta))) along (gamma2,
    gamma3); the samples are lifted back to the sphere by normalisation.
    """
    device = resolve_device(device)
    kappa, beta, (g1, g2, g3) = _params(params)
    var_u = 1.0 / max(kappa - 2.0 * beta, 1e-6)
    var_v = 1.0 / max(kappa + 2.0 * beta, 1e-6)
    rng = np.random.default_rng(seed)
    u = rng.normal(0.0, np.sqrt(var_u), size=n)
    v = rng.normal(0.0, np.sqrt(var_v), size=n)
    x = g1[None, :] + u[:, None] * g2[None, :] + v[:, None] * g3[None, :]
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.from_numpy(x).to(device)


def _kent_axes(params, img_size, samples, seed, image, title,
               device) -> Axes:
    f = kent_density_erp(params, img_size, normalize=False,
                         device=device).cpu().numpy()
    h, w = img_size
    p = torch.as_tensor(params, dtype=torch.float64).reshape(5).tolist()
    ax = Axes(w, h, (0.0, 360.0), (180.0, 0.0),
              title=title or "Kent density  kappa={:.3g} beta={:.3g}".format(
                  *p[:2]),
              xlabel="theta (deg)", ylabel="phi (deg)")
    if image is not None:
        ax.image(np.asarray(image, np.uint8))
        ax.image(f, cmap="inferno", alpha=0.55)
    else:
        ax.image(f, cmap="inferno")
    if samples:
        th, ph = directions_to_erp_deg(sample_kent(params, samples, seed,
                                                   device))
        ax.scatter(th.cpu().numpy(), ph.cpu().numpy(), (0, 255, 255),
                   radius=1, alpha=0.6)
    return ax


def plot_kent_density(params, img_size=(256, 512), samples=0, seed=0,
                      image=None, out_file=None, title=None,
                      device=None) -> np.ndarray:
    """The density's heat map on the ERP chart (theta right, phi down), one
    plot pixel a raster pixel, over an optional (H, W, 3) uint8 ERP
    ``image`` (resized to the raster, the heat map blended at 0.55), with
    ``samples`` samples in cyan. Returns the rendered uint8 array and
    writes it to ``out_file`` where given."""
    ax = _kent_axes(params, img_size, samples, seed, image, title, device)
    return ax.save(out_file) if out_file is not None else ax.render()

"""Perspective (tangent-plane / gnomonic) camera over ERP images.

A pinhole view of an ERP panorama looking at a spherical direction
(``extract``), the border of a BFoV / RBFoV box rasterised onto the ERP
frame (the border is exactly the image border of a camera whose FoVs are
the box's, rolled by gamma), and seam-aware planar enclosing boxes.

``extract`` samples on ``device`` (``None``: the CUDA device) in float64:
bilinear, longitude-wrapped at the seam, latitude clamped at the poles. The
box geometry (``box_border_px``, ``draw_box``, ``planar_bbox``) is a few
hundred points of float64 numpy on the host, the JAX package's arithmetic,
so that ``draw_box`` draws the same pixels.

Angles are in the framework's degrees: theta in [0, 360) longitude, phi in
[0, 180) colatitude.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def _unit_frame(theta: float, phi: float):
    """Orthonormal (look, right, up) for angles in radians."""
    st, ct, sp, cp = np.sin(theta), np.cos(theta), np.sin(phi), np.cos(phi)
    look = np.array([sp * ct, sp * st, cp])
    right = np.array([-st, ct, 0.0])
    up = np.array([-cp * ct, -cp * st, sp])
    return look, right, up


def _dirs_to_erp_px(dirs: np.ndarray, erp_w: int, erp_h: int) -> np.ndarray:
    """Unit direction vectors (..., 3) -> ERP pixel coords (..., 2)."""
    theta = np.mod(np.arctan2(dirs[..., 1], dirs[..., 0]), 2 * np.pi)
    phi = np.arccos(np.clip(dirs[..., 2], -1.0, 1.0))
    u = theta / (2 * np.pi) * erp_w
    v = phi / np.pi * erp_h
    return np.stack([u, v], axis=-1)


class PerspectiveCamera:
    """Pinhole camera with fixed FoVs over an ERP panorama.

    The larger-FoV side of the view gets ``long_side`` pixels, the other
    side scales by the ratio of the FoVs' tangents.
    """

    def __init__(self, erp_w: int, erp_h: int, fov_w: float = 64.0,
                 fov_h: float = 64.0, long_side: int = 640, device=None):
        self.erp_w, self.erp_h = int(erp_w), int(erp_h)
        self.fov_w, self.fov_h = float(fov_w), float(fov_h)
        self.device = resolve_device(device)
        tw = np.tan(np.deg2rad(fov_w) / 2)
        th = np.tan(np.deg2rad(fov_h) / 2)
        if fov_w >= fov_h:
            self.img_w = int(long_side)
            self.img_h = max(int(round(long_side * th / tw)), 1)
        else:
            self.img_h = int(long_side)
            self.img_w = max(int(round(long_side * tw / th)), 1)
        # the tangent-plane sample grid at pixel centres
        xs = (np.arange(self.img_w) + 0.5) / self.img_w * 2 - 1  # [-1, 1)
        ys = (np.arange(self.img_h) + 0.5) / self.img_h * 2 - 1
        self._tx = torch.from_numpy(xs * tw).to(self.device)
        self._ty = torch.from_numpy(ys * th).to(self.device)

    # ------------------------------------------------------------- extract
    def view_directions(self, theta_deg: float,
                        phi_deg: float) -> torch.Tensor:
        """(img_h, img_w, 3) float64 unit directions of the view at the
        given centre, on the camera's device."""
        look, right, up = (torch.from_numpy(v).to(self.device)
                           for v in _unit_frame(np.deg2rad(theta_deg),
                                                np.deg2rad(phi_deg)))
        tx = self._tx[None, :, None]
        ty = self._ty[:, None, None]
        d = look + tx * right - ty * up  # image v grows downward
        return d / torch.sqrt((d * d).sum(-1, keepdim=True))

    def extract(self, image, theta_deg: float, phi_deg: float):
        """Perspective view of the ERP image at (theta, phi) degrees:
        bilinear, longitude-wrapped at the seam, latitude clamped at the
        poles, in float64 on the camera's device. ``image``: (H, W[, C]), a
        numpy array (the view comes back as one) or a tensor (the view stays
        on the device); returns (img_h, img_w[, C]) in the input's dtype,
        integers rounded half to even and clipped to their range."""
        as_numpy = not isinstance(image, torch.Tensor)
        img = torch.as_tensor(np.asarray(image)) if as_numpy else image
        dtype = img.dtype
        squeeze = img.ndim == 2
        img = img.to(self.device, torch.float64)
        if squeeze:
            img = img[..., None]
        h, w = img.shape[:2]
        d = self.view_directions(theta_deg, phi_deg)
        theta = torch.remainder(torch.atan2(d[..., 1], d[..., 0]),
                                2 * np.pi)
        phi = torch.arccos(d[..., 2].clamp(-1.0, 1.0))
        u = theta / (2 * np.pi) * w - 0.5
        v = phi / np.pi * h - 0.5
        u0, v0 = torch.floor(u), torch.floor(v)
        fu, fv = (u - u0)[..., None], (v - v0)[..., None]
        u0, v0 = u0.long(), v0.long()
        u0w, u1w = torch.remainder(u0, w), torch.remainder(u0 + 1, w)
        v0c, v1c = v0.clamp(0, h - 1), (v0 + 1).clamp(0, h - 1)
        out = (img[v0c, u0w] * (1 - fu) * (1 - fv)
               + img[v0c, u1w] * fu * (1 - fv)
               + img[v1c, u0w] * (1 - fu) * fv
               + img[v1c, u1w] * fu * fv)
        if not dtype.is_floating_point:
            info = torch.iinfo(dtype)
            out = torch.round(out).clamp(info.min, info.max)
        out = out.to(dtype)
        if squeeze:
            out = out[..., 0]
        return out.cpu().numpy() if as_numpy else out

    # ------------------------------------------------------ box rasterising
    def box_border_px(self, box_deg, samples_per_edge: int = 64) -> np.ndarray:
        """ERP pixel coords of a BFoV / RBFoV box border through the camera:
        the image border of a pinhole camera looking at (theta, phi) with
        FoVs (alpha, beta), rolled by gamma. Returns (4 * samples_per_edge,
        2) float64."""
        box = np.asarray(box_deg, np.float64)
        look, right, up = _unit_frame(np.deg2rad(box[0]), np.deg2rad(box[1]))
        hx = np.tan(np.deg2rad(box[2]) / 2)
        hy = np.tan(np.deg2rad(box[3]) / 2)
        t = np.linspace(-1.0, 1.0, samples_per_edge, endpoint=False)
        one = np.ones_like(t)
        # counter-clockwise border of the tangent rectangle
        x = np.concatenate([t, one, -t, -one]) * hx
        y = np.concatenate([-one, t, one, -t]) * hy
        if box.shape[0] == 5:
            g = np.deg2rad(box[4])
            cg, sg = np.cos(g), np.sin(g)
            x, y = x * cg - y * sg, x * sg + y * cg
        d = (look[None, :] + x[:, None] * right[None, :]
             + y[:, None] * up[None, :])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return _dirs_to_erp_px(d, self.erp_w, self.erp_h)

    def draw_box(self, image: np.ndarray, box_deg, color=(255, 0, 0),
                 thickness: int = 2, samples_per_edge: int = 64) -> np.ndarray:
        """Rasterise a box border onto an ERP frame (PIL): a polyline split
        where it wraps the seam."""
        from PIL import Image, ImageDraw

        img = Image.fromarray(np.ascontiguousarray(image.astype(np.uint8)))
        draw = ImageDraw.Draw(img)
        px = self.box_border_px(box_deg, samples_per_edge)
        px = np.concatenate([px, px[:1]])  # close the loop
        start = 0
        for k in range(1, len(px)):
            if abs(px[k, 0] - px[k - 1, 0]) > self.erp_w / 2:
                if k - start >= 2:
                    draw.line([tuple(p) for p in px[start:k]],
                              fill=tuple(color), width=thickness)
                start = k
        if len(px) - start >= 2:
            draw.line([tuple(p) for p in px[start:]],
                      fill=tuple(color), width=thickness)
        return np.asarray(img)

    def planar_bbox(self, box_deg, samples_per_edge: int = 64) -> np.ndarray:
        """Seam-aware planar xyxy enclosing the box border on the ERP frame:
        where the border wraps the theta seam, the wider of the two pixel
        clusters."""
        px = self.box_border_px(box_deg, samples_per_edge)
        u, v = px[:, 0], px[:, 1]
        ymin, ymax = float(v.min()), float(v.max())
        if u.max() - u.min() < self.erp_w / 2:
            return np.array([u.min(), ymin, u.max(), ymax])
        left = u[u < self.erp_w / 2]
        right = u[u >= self.erp_w / 2]
        w_left = left.max() - left.min() if left.size else -1.0
        w_right = right.max() - right.min() if right.size else -1.0
        side = left if w_left >= w_right else right
        return np.array([side.min(), ymin, side.max(), ymax])

"""Box format conversions: spherical degrees <-> planar pixel / tangent
charts.

All functions are elementwise over leading axes; box layouts on the last
axis:

- spherical (degrees): (theta, phi, alpha, beta[, gamma])
- planar xywh / xyxy:  pixel coordinates in an (img_h, img_w) ERP chart
- planar obb:          (cx, cy, w, h, angle_rad)
"""

from __future__ import annotations

import math

import torch

DEFAULT_IMG_SIZE = (512, 1024)  # (H, W) ERP chart used when only ratios matter


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def obb2hbb_xywh(obb: torch.Tensor) -> torch.Tensor:
    """Axis-aligned cover of a rotated box, xywh layout."""
    cx, cy, w, h, a = obb.unbind(-1)
    cos_a, sin_a = torch.cos(a).abs(), torch.sin(a).abs()
    return torch.stack([cx, cy, cos_a * w + sin_a * h, sin_a * w + cos_a * h],
                       dim=-1)


def obb2hbb_xyxy(obb: torch.Tensor) -> torch.Tensor:
    return xywh2xyxy(obb2hbb_xywh(obb))


def bfov2rbfov(bfov: torch.Tensor) -> torch.Tensor:
    """Append a zero rotation column: (..., 4) -> (..., 5)."""
    return torch.cat([bfov, torch.zeros_like(bfov[..., :1])], dim=-1)


def geo2sph(boxes: torch.Tensor) -> torch.Tensor:
    """Geographic (lon in [-180, 180], lat in [90, -90]) -> internal
    degrees; a new tensor, the input is not written."""
    out = boxes.clone()
    out[..., 0] = boxes[..., 0] + 180.0
    out[..., 1] = 90.0 - boxes[..., 1]
    return out


def sph2geo(boxes: torch.Tensor) -> torch.Tensor:
    out = boxes.clone()
    out[..., 0] = boxes[..., 0] - 180.0
    out[..., 1] = 90.0 - boxes[..., 1]
    return out


def sph2pix_box_transform(boxes, img_size=DEFAULT_IMG_SIZE):
    """Equirectangular chart: linear degree -> pixel scaling (xywh out)."""
    img_h, img_w = img_size
    t, p, a, b = (boxes[..., i] for i in range(4))
    return torch.stack(
        [t / 360.0 * img_w, p / 180.0 * img_h,
         a / 360.0 * img_w, b / 180.0 * img_h], dim=-1)


def pix2sph_box_transform(boxes, img_size=DEFAULT_IMG_SIZE):
    img_h, img_w = img_size
    x, y, w, h = (boxes[..., i] for i in range(4))
    return torch.stack(
        [x / img_w * 360.0, y / img_h * 180.0,
         w / img_w * 360.0, h / img_h * 180.0], dim=-1)


def sph2tan_box_transform(boxes, img_size=DEFAULT_IMG_SIZE):
    """Gnomonic sizes: extents become tangent-plane lengths (xywh out)."""
    img_h, img_w = img_size
    t, p, a, b = (boxes[..., i] for i in range(4))
    two_r = img_w / math.pi
    return torch.stack(
        [t / 360.0 * img_w, p / 180.0 * img_h,
         two_r * torch.tan(torch.deg2rad(a) / 2.0),
         two_r * torch.tan(torch.deg2rad(b) / 2.0)], dim=-1)


def tan2sph_box_transform(boxes, img_size=DEFAULT_IMG_SIZE):
    img_h, img_w = img_size
    x, y, w, h = (boxes[..., i] for i in range(4))
    two_r = img_w / math.pi
    return torch.stack(
        [x / img_w * 360.0, y / img_h * 180.0,
         torch.rad2deg(2.0 * torch.atan(w / two_r)),
         torch.rad2deg(2.0 * torch.atan(h / two_r))], dim=-1)


_PLANAR2SPH = {
    "sph2pix": pix2sph_box_transform,
    "pix2sph": pix2sph_box_transform,
    "sph2tan": tan2sph_box_transform,
    "tan2sph": tan2sph_box_transform,
}


def sph2planar_boxes(boxes, img_size=DEFAULT_IMG_SIZE):
    """Spherical degrees -> planar boxes in the equirectangular chart.

    BFoV returns xyxy; RBFoV returns (x, y, w, h, -gamma_rad) obb.
    """
    if boxes.shape[-1] == 4:
        return xywh2xyxy(sph2pix_box_transform(boxes, img_size))
    xywh = sph2pix_box_transform(boxes[..., :4], img_size)
    angle = -torch.deg2rad(boxes[..., 4:5])
    return torch.cat([xywh, angle], dim=-1)


def planar2sph_boxes(boxes, mode="sph2pix", box_version=4,
                     img_size=DEFAULT_IMG_SIZE):
    """Planar xyxy -> spherical degrees through the chart ``mode`` names;
    ``box_version`` 5 appends a zero rotation."""
    sph = _PLANAR2SPH[mode](xyxy2xywh(boxes), img_size)
    if box_version == 5:
        return bfov2rbfov(sph)
    return sph

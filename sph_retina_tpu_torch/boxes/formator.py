"""Box format conversions: spherical degrees -> planar pixel chart.

All functions are elementwise over leading axes; box layouts on the last
axis:

- spherical (degrees): (theta, phi, alpha, beta[, gamma])
- planar xywh / xyxy:  pixel coordinates in an (img_h, img_w) ERP chart
- planar obb:          (cx, cy, w, h, angle_rad)
"""

from __future__ import annotations

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


def sph2pix_box_transform(boxes, img_size=DEFAULT_IMG_SIZE):
    """Equirectangular chart: linear degree -> pixel scaling (xywh out)."""
    img_h, img_w = img_size
    t, p, a, b = (boxes[..., i] for i in range(4))
    return torch.stack(
        [t / 360.0 * img_w, p / 180.0 * img_h,
         a / 360.0 * img_w, b / 180.0 * img_h], dim=-1)


def sph2planar_boxes(boxes, img_size=DEFAULT_IMG_SIZE):
    """Spherical degrees -> planar boxes in the equirectangular chart.

    BFoV returns xyxy; RBFoV returns (x, y, w, h, -gamma_rad) obb.
    """
    if boxes.shape[-1] == 4:
        return xywh2xyxy(sph2pix_box_transform(boxes, img_size))
    xywh = sph2pix_box_transform(boxes[..., :4], img_size)
    angle = -torch.deg2rad(boxes[..., 4:5])
    return torch.cat([xywh, angle], dim=-1)

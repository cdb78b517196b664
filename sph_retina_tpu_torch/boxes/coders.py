"""Box coder: delta encode/decode in spherical degrees.

dx, dy are normalised by the anchor's field of view, dw, dh are log ratios,
and the rotation delta of a 5-dof box is encoded deg -> rad and decoded
rad -> deg; decode clamps to the open coordinate ranges, gamma to (-90, 90).
Pure functions over (..., D) tensors; means/stds follow mmdet conventions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

_EPS = 1e-7


@dataclasses.dataclass(frozen=True)
class SphBBoxCoder:
    """Delta coder for BFoV (4) and RBFoV (5) spherical boxes."""

    box_version: int = 4
    target_means: Sequence[float] | None = None
    target_stds: Sequence[float] | None = None
    wh_ratio_clip: float = 16.0 / 1000.0
    clip_border: bool = True

    def _means_stds(self, like: torch.Tensor):
        d = self.box_version
        means = self.target_means if self.target_means is not None else (0.0,) * d
        stds = self.target_stds if self.target_stds is not None else (1.0,) * d
        return (torch.tensor(means, dtype=torch.float32, device=like.device),
                torch.tensor(stds, dtype=torch.float32, device=like.device))

    def encode(self, anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """Deltas of gt w.r.t. anchors; both (..., box_version) degrees."""
        means, stds = self._means_stds(anchors)
        px, py = anchors[..., 0], anchors[..., 1]
        pw = anchors[..., 2].clamp_min(_EPS)
        ph = anchors[..., 3].clamp_min(_EPS)
        gw = gt[..., 2].clamp_min(_EPS)
        gh = gt[..., 3].clamp_min(_EPS)
        cols = [
            (gt[..., 0] - px) / pw,
            (gt[..., 1] - py) / ph,
            torch.log(gw / pw),
            torch.log(gh / ph),
        ]
        if self.box_version == 5:
            cols.append(torch.deg2rad(gt[..., 4] - anchors[..., 4]))
        deltas = torch.stack(cols, dim=-1)
        return (deltas - means) / stds

    def decode(self, anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        """Apply deltas to anchors -> spherical boxes (degrees, clamped)."""
        means, stds = self._means_stds(anchors)
        d = deltas * stds + means
        max_ratio = abs(math.log(self.wh_ratio_clip))
        dw = d[..., 2].clamp(-max_ratio, max_ratio)
        dh = d[..., 3].clamp(-max_ratio, max_ratio)
        theta = anchors[..., 0] + anchors[..., 2] * d[..., 0]
        phi = anchors[..., 1] + anchors[..., 3] * d[..., 1]
        alpha = anchors[..., 2] * torch.exp(dw)
        beta = anchors[..., 3] * torch.exp(dh)
        cols = [theta, phi, alpha, beta]
        if self.box_version == 5:
            cols.append(anchors[..., 4] + torch.rad2deg(d[..., 4]))
        boxes = torch.stack(cols, dim=-1)
        if self.clip_border:
            lo, hi = self.clip_bounds(boxes.device)
            boxes = torch.minimum(torch.maximum(boxes, lo), hi)
        return boxes

    def clip_bounds(self, device=None):
        """(lo, hi) tensors of the open ranges ``decode`` clamps to."""
        lo = [_EPS, _EPS, _EPS, _EPS]
        hi = [360.0 - _EPS, 180.0 - _EPS, 180.0 - _EPS, 180.0 - _EPS]
        if self.box_version == 5:
            lo.append(-90.0 + _EPS)
            hi.append(90.0 - _EPS)
        return (torch.tensor(lo, dtype=torch.float32, device=device),
                torch.tensor(hi, dtype=torch.float32, device=device))


@dataclasses.dataclass(frozen=True)
class DistancePointSphBBoxCoder:
    """FCOS-style coder: spherical box <-> (l, t, r, b) pixel distances.

    Boxes are converted to pixel-plane xyxy in a fixed ERP chart, distances
    are measured there, and ``decode`` maps back to spherical degrees,
    clamped to the open coordinate ranges.
    """

    img_size: tuple = (512, 1024)  # (H, W) chart
    box_version: int = 4

    def _scale(self):
        img_h, img_w = self.img_size
        return img_w / 360.0, img_h / 180.0

    def encode(self, points: torch.Tensor, gt: torch.Tensor, max_dis=None,
               eps=0.1) -> torch.Tensor:
        """points: (..., 2) pixel centres; gt: (..., 4) spherical degrees."""
        sx, sy = self._scale()
        cx, cy = gt[..., 0] * sx, gt[..., 1] * sy
        w, h = gt[..., 2] * sx, gt[..., 3] * sy
        left = points[..., 0] - (cx - w / 2)
        top = points[..., 1] - (cy - h / 2)
        right = (cx + w / 2) - points[..., 0]
        bottom = (cy + h / 2) - points[..., 1]
        d = torch.stack([left, top, right, bottom], dim=-1)
        if max_dis is not None:
            d = d.clamp(0.0, max_dis - eps)
        return d

    def decode(self, points: torch.Tensor,
               distances: torch.Tensor) -> torch.Tensor:
        sx, sy = self._scale()
        x1 = points[..., 0] - distances[..., 0]
        y1 = points[..., 1] - distances[..., 1]
        x2 = points[..., 0] + distances[..., 2]
        y2 = points[..., 1] + distances[..., 3]
        theta = (x1 + x2) / 2.0 / sx
        phi = (y1 + y2) / 2.0 / sy
        alpha = (x2 - x1) / sx
        beta = (y2 - y1) / sy
        return torch.stack([theta.clamp(_EPS, 360.0 - _EPS),
                            phi.clamp(_EPS, 180.0 - _EPS),
                            alpha.clamp(_EPS, 180.0 - _EPS),
                            beta.clamp(_EPS, 180.0 - _EPS)], dim=-1)

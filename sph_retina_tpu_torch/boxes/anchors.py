"""Spherical anchor generation.

Planar grid anchors (base anchors from strides/ratios/octave scales, shifted
over the feature grid) converted pixel -> spherical degrees per FPN level.

Anchors are deterministic constants per (config, feature-map sizes): they are
generated on the host with numpy once and moved to the device as tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SphAnchorGenerator:
    """BFoV/RBFoV anchor generator; attributes mirror the config surface
    (``model.anchor_generator`` of ``configs/_base_/sph_retinanet_r50_fpn.py``)."""

    strides: Sequence[int]
    ratios: Sequence[float] = (0.5, 1.0, 2.0)
    scales: Sequence[float] | None = None
    octave_base_scale: int | None = None
    scales_per_octave: int | None = None
    base_sizes: Sequence[int] | None = None
    center_offset: float = 0.0
    box_version: int = 4
    box_formator: str = "sph2pix"

    def _scales(self) -> np.ndarray:
        if self.scales is not None:
            return np.asarray(self.scales, np.float32)
        octaves = np.array(
            [2 ** (i / self.scales_per_octave)
             for i in range(self.scales_per_octave)]
        )
        return (octaves * self.octave_base_scale).astype(np.float32)

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> int:
        return len(self.ratios) * len(self._scales())

    def base_anchors(self, level: int) -> np.ndarray:
        """(A, 4) xyxy planar base anchors for one level."""
        base_size = (
            self.base_sizes[level] if self.base_sizes is not None
            else self.strides[level]
        )
        scales = self._scales()
        ratios = np.asarray(self.ratios, np.float32)
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        ws = (base_size * w_ratios[:, None] * scales[None, :]).reshape(-1)
        hs = (base_size * h_ratios[:, None] * scales[None, :]).reshape(-1)
        cx = self.center_offset * base_size
        cy = self.center_offset * base_size
        return np.stack(
            [cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs],
            axis=-1,
        ).astype(np.float32)

    def single_level_grid_anchors(self, featmap_size, level: int) -> np.ndarray:
        """(H*W*A, box_version) spherical anchors in degrees."""
        feat_h, feat_w = featmap_size
        stride = self.strides[level]
        shift_x = np.arange(feat_w, dtype=np.float32) * stride
        shift_y = np.arange(feat_h, dtype=np.float32) * stride
        xx = np.tile(shift_x, feat_h)
        yy = np.repeat(shift_y, feat_w)
        shifts = np.stack([xx, yy, xx, yy], axis=-1)  # (K, 4)
        planar = (self.base_anchors(level)[None, :, :]
                  + shifts[:, None, :]).reshape(-1, 4)

        img_h, img_w = feat_h * stride, feat_w * stride
        sph = self._planar2sph(planar, (img_h, img_w))
        if self.box_version == 5:
            sph = np.concatenate([sph, np.zeros_like(sph[:, :1])], axis=-1)
        return sph

    def _planar2sph(self, xyxy: np.ndarray, img_size) -> np.ndarray:
        img_h, img_w = img_size
        x = (xyxy[:, 0] + xyxy[:, 2]) / 2.0
        y = (xyxy[:, 1] + xyxy[:, 3]) / 2.0
        w = xyxy[:, 2] - xyxy[:, 0]
        h = xyxy[:, 3] - xyxy[:, 1]
        if self.box_formator in ("sph2pix", "pix2sph"):
            alpha = w / img_w * 360.0
            beta = h / img_h * 180.0
        else:  # tangent-plane sizes (sph2tan/tan2sph)
            two_r = img_w / math.pi
            alpha = np.rad2deg(2.0 * np.arctan(w / two_r))
            beta = np.rad2deg(2.0 * np.arctan(h / two_r))
        theta = x / img_w * 360.0
        phi = y / img_h * 180.0
        return np.stack([theta, phi, alpha, beta], axis=-1).astype(np.float32)

    def grid_anchors(self, featmap_sizes: Sequence[tuple],
                     device=None) -> list:
        """Per-level spherical anchors as fp32 tensors on ``device``."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(
                f"{len(featmap_sizes)} feature maps for {self.num_levels} levels")
        return [
            torch.from_numpy(self.single_level_grid_anchors(fs, i)).to(device)
            for i, fs in enumerate(featmap_sizes)
        ]

    def flat_anchors(self, featmap_sizes, device=None) -> torch.Tensor:
        """All levels concatenated: (sum_l H_l*W_l*A, box_version)."""
        return torch.cat(self.grid_anchors(featmap_sizes, device), dim=0)


def kent_grid_anchors(generator: SphAnchorGenerator, featmap_sizes,
                      device=None) -> list:
    """Per-level grid anchors as canonical Kent parameters (pixel ->
    spherical -> Kent). Detectors always consume spherical anchors; these
    are an explicit precomputation for Kent assignment and loss paths."""
    from ..iou.kent import deg2kent

    return [deg2kent(a) for a in generator.grid_anchors(featmap_sizes, device)]


@dataclasses.dataclass(frozen=True)
class SphSSDAnchorGenerator(SphAnchorGenerator):
    """SSD-style anchors: per-level min/max sizes and a ratio set. The base
    anchors of a level are (min_size, sqrt(min * max)) at ratio 1 plus
    min_size at each extra ratio and its inverse."""

    min_sizes: Sequence[float] = ()
    max_sizes: Sequence[float] = ()
    level_ratios: Sequence[Sequence[float]] = ()

    @property
    def num_base_anchors(self):  # varies by level
        raise AttributeError("use num_base_anchors_per_level")

    @property
    def num_base_anchors_per_level(self):
        return [2 + 2 * len(r) for r in self.level_ratios]

    def base_anchors(self, level: int) -> np.ndarray:
        mn, mx = self.min_sizes[level], self.max_sizes[level]
        ws = [mn, math.sqrt(mn * mx)]
        hs = [mn, math.sqrt(mn * mx)]
        for r in self.level_ratios[level]:
            sr = math.sqrt(r)
            ws += [mn * sr, mn / sr]
            hs += [mn / sr, mn * sr]
        ws = np.asarray(ws, np.float32)
        hs = np.asarray(hs, np.float32)
        cx = cy = self.center_offset * self.strides[level]
        return np.stack(
            [cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs],
            axis=-1,
        ).astype(np.float32)

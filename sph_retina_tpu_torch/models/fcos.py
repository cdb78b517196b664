"""FCOS spherical detector: anchor-free head + functional loss/predict.

The head has GroupNorm towers, a learnable scale a level and exp-activated
distances (mmdet's FCOS defaults), with a ``box_version``-wide regression
conv. Targets convert the gts (spherical degrees) to pixel xyxy in the ERP
chart and assign each point the gt of least area that holds it inside the
level's regress range; the decoded-box loss is centerness-weighted and runs
on every point (no gather).

Targets are one masked min-area reduction over (B, P points, G padded gts):
no per-image Python, nothing sized by the data. Precision: GroupNorm runs in
fp32 (eps 1e-6, Flax's default, where ``torch.nn.GroupNorm`` defaults to
1e-5) between bf16 convolutions, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..boxes.coders import DistancePointSphBBoxCoder
from ..boxes.nms import NMSResult, sph_batched_nms
from ..losses.focal_loss import _bce_with_logits, sigmoid_focal_loss
from ..parallel import global_count
from .fpn import FPN
from .resnet import Conv2d, ResNet, seeded_init_
from .single_stage import _select_level

INF = 1e8
GN_EPS = 1e-6  # Flax nn.GroupNorm's default


class Scale(nn.Module):
    """A learned scalar (the Flax ``scale`` is its ``weight``)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(()))

    def forward(self, x):
        return x * self.weight


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm``; on a head split over "space" (``space``, set by
    ``parallel.sharding.partition_spatially``) with its statistics over
    every rank's columns."""

    space = None

    def forward(self, x):
        if self.space is not None:
            return self.space.group_norm(self, x)
        return super().forward(x)


class SphFCOSHead(nn.Module):
    # each point's outputs and loss need only its own cell's neighbourhood
    # (and the GroupNorms' statistics, all-reduced): the head splits over
    # "space" (``parallel/sharding.py``)
    splits_over_space = True

    def __init__(self, num_classes: int, box_version: int = 4,
                 in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, num_levels: int = 5):
        super().__init__()
        self.num_classes = num_classes
        self.box_version = box_version
        self.stacked_convs = stacked_convs
        for tower in ("cls", "reg"):
            for i in range(stacked_convs):
                c = in_channels if i == 0 else feat_channels
                self.add_module(f"{tower}_conv_{i}",
                                Conv2d(c, feat_channels, 3, 1, 1, bias=False))
                self.add_module(f"{tower}_gn_{i}",
                                GroupNorm(32, feat_channels, eps=GN_EPS))
        self.conv_cls = Conv2d(feat_channels, num_classes, 3, 1, 1)
        self.conv_reg = Conv2d(feat_channels, box_version, 3, 1, 1)
        self.conv_centerness = Conv2d(feat_channels, 1, 3, 1, 1)
        for i in range(num_levels):
            self.add_module(f"scale_{i}", Scale())
        with torch.no_grad():
            self.conv_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def _tower(self, tower: str, x):
        for i in range(self.stacked_convs):
            y = getattr(self, f"{tower}_conv_{i}")(x).float()
            x = F.relu(getattr(self, f"{tower}_gn_{i}")(y)).to(x.dtype)
        return x

    def forward(self, feats):
        """feats: (B, C, H, W) levels -> (cls_scores, bbox_preds,
        centernesses), per level (B, H*W, C), (B, H*W, D) and (B, H*W)
        fp32, in the (h, w) order of the points."""
        cls_scores, bbox_preds, centernesses = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat = self._tower("cls", x)
            reg_feat = self._tower("reg", x)
            b, _, h, w = x.shape
            cls_out = self.conv_cls(cls_feat).float()
            reg_out = torch.exp(getattr(self, f"scale_{lvl}")(
                self.conv_reg(reg_feat).float()))  # positive distances
            ctr_out = self.conv_centerness(reg_feat).float()
            cls_scores.append(
                cls_out.permute(0, 2, 3, 1).reshape(b, h * w, -1))
            bbox_preds.append(
                reg_out.permute(0, 2, 3, 1).reshape(b, h * w, -1))
            centernesses.append(ctr_out.reshape(b, h * w))
        return cls_scores, bbox_preds, centernesses


class SphFCOS(nn.Module):
    """ResNet + FPN (from C3, extra levels on the backbone's last output) +
    FCOS head."""

    def __init__(self, num_classes: int, box_version: int = 4,
                 depth: int = 50, dtype: torch.dtype = torch.bfloat16,
                 groups: int = 1, base_width: int = 64, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(0, 1, 2, 3),
                               groups=groups, base_width=base_width,
                               remat=remat)
        self.neck = FPN(self.backbone.out_channels, out_channels=256,
                        start_level=1, num_outs=5)
        self.bbox_head = SphFCOSHead(num_classes=num_classes,
                                     box_version=box_version)

    def forward(self, images: torch.Tensor):
        """images: (B, H, W, 3) float, normalised -> head outputs."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        return self.bbox_head(self.neck(self.backbone(x)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``seeded_init_`` with the focal prior on ``conv_cls``'s bias."""
        seeded_init_(self, generator)
        self.bbox_head.conv_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))


# --------------------------------------------------------------------------- #
# config / points / targets
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FCOSConfig:
    num_classes: int
    box_version: int = 4
    img_size: tuple = (512, 1024)
    strides: tuple = (8, 16, 32, 64, 128)
    regress_ranges: tuple = ((-1, 64), (64, 128), (128, 256), (256, 512),
                             (512, INF))
    center_sampling: bool = False
    center_sample_radius: float = 1.5
    loss_bbox: Callable = None
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_per_img: int = 100
    nms_backend: str = "planar"

    def featmap_sizes(self):
        h, w = self.img_size
        return [(-(-h // s), -(-w // s)) for s in self.strides]

    def coder(self) -> DistancePointSphBBoxCoder:
        return DistancePointSphBBoxCoder(img_size=self.img_size,
                                         box_version=self.box_version)

    def level_points(self, device=None):
        """Per level: (P_l, 2) pixel centres, (P_l,) strides and (P_l, 2)
        regress ranges, made on ``device``."""
        pts, strides, ranges = [], [], []
        for (h, w), s, rr in zip(self.featmap_sizes(), self.strides,
                                 self.regress_ranges):
            ys, xs = torch.meshgrid(torch.arange(h, device=device),
                                    torch.arange(w, device=device),
                                    indexing="ij")
            p = torch.stack([(xs.reshape(-1) + 0.5) * s,
                             (ys.reshape(-1) + 0.5) * s], dim=-1)
            n = p.shape[0]
            pts.append(p.float())
            strides.append(torch.full((n,), float(s), device=device))
            ranges.append(torch.stack(
                [torch.full((n,), float(v), device=device) for v in rr], -1))
        return pts, strides, ranges


def fcos_config(num_classes, img_size=(512, 1024), loss_bbox=None, **kw):
    from ..losses import sph_iou_loss

    return FCOSConfig(num_classes=num_classes, img_size=tuple(img_size),
                      loss_bbox=loss_bbox or sph_iou_loss, **kw)


class FCOSTargets(NamedTuple):
    labels: torch.Tensor        # (B, P) int32, num_classes = background
    bbox_targets: torch.Tensor  # (B, P, 4[+1]) l/t/r/b distances (+gamma)
    centerness: torch.Tensor    # (B, P)


def _gt_to_chart_xyxy(gt_boxes, img_size):
    h, w = img_size
    sx, sy = w / 360.0, h / 180.0
    cx, cy = gt_boxes[..., 0] * sx, gt_boxes[..., 1] * sy
    bw, bh = gt_boxes[..., 2] * sx, gt_boxes[..., 3] * sy
    return torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                       dim=-1)


@torch.no_grad()
def fcos_targets(cfg: FCOSConfig, gt_boxes, gt_labels, gt_mask,
                 level_points=None) -> FCOSTargets:
    """(B, G, D) padded gts -> per-point targets of the whole batch.
    ``level_points``: ``cfg.level_points(device)``, if already made."""
    pts, strides, ranges = level_points or cfg.level_points(gt_boxes.device)
    points = torch.cat(pts)            # (P, 2)
    stride = torch.cat(strides)        # (P,)
    rr = torch.cat(ranges)             # (P, 2)

    xyxy = _gt_to_chart_xyxy(gt_boxes.float(), cfg.img_size)   # (B, G, 4)
    areas = (xyxy[..., 2] - xyxy[..., 0]) * (xyxy[..., 3] - xyxy[..., 1])
    xs, ys = points[:, 0:1], points[:, 1:2]                    # (P, 1)
    x1, y1 = xyxy[:, None, :, 0], xyxy[:, None, :, 1]          # (B, 1, G)
    x2, y2 = xyxy[:, None, :, 2], xyxy[:, None, :, 3]
    dists = torch.stack([xs - x1, ys - y1, x2 - xs, y2 - ys],
                        dim=-1)                                # (B, P, G, 4)

    if cfg.center_sampling:
        r = cfg.center_sample_radius * stride[:, None]         # (P, 1)
        cxs, cys = (x1 + x2) / 2, (y1 + y2) / 2
        x_min = torch.maximum(cxs - r, x1)
        y_min = torch.maximum(cys - r, y1)
        x_max = torch.minimum(cxs + r, x2)
        y_max = torch.minimum(cys + r, y2)
        inside = (xs > x_min) & (xs < x_max) & (ys > y_min) & (ys < y_max)
    else:
        inside = dists.amin(dim=-1) > 0

    max_dist = dists.amax(dim=-1)
    in_range = (max_dist >= rr[:, 0:1]) & (max_dist <= rr[:, 1:2])

    cand_areas = torch.where(inside & in_range & gt_mask[:, None, :],
                             areas[:, None, :], INF)
    # the first minimum, as jnp.argmin takes it
    min_idx = cand_areas.argmin(dim=-1)                        # (B, P)
    pos = cand_areas.gather(-1, min_idx[..., None])[..., 0] < INF

    labels = torch.where(pos, gt_labels.to(torch.int64).gather(1, min_idx),
                         cfg.num_classes)
    tgt = dists.gather(2, min_idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    if cfg.box_version == 5:
        gamma = gt_boxes[..., 4].float().gather(1, min_idx)
        tgt = torch.cat([tgt, gamma[..., None]], dim=-1)
    left, top, right, bottom = tgt.unbind(-1)[:4]
    ctr = torch.sqrt(torch.clamp(
        (torch.minimum(left, right)
         / torch.maximum(left, right).clamp_min(1e-6))
        * (torch.minimum(top, bottom)
           / torch.maximum(top, bottom).clamp_min(1e-6)), 0.0, 1.0))
    return FCOSTargets(labels.to(torch.int32), tgt,
                       torch.where(pos, ctr, 0.0))


def fcos_loss(cfg: FCOSConfig, cls_scores, bbox_preds, centernesses,
              gt_boxes, gt_labels, gt_mask, level_points=None) -> dict:
    """Losses of one batch as 0-dim tensors: sigmoid focal over every point,
    ``loss_bbox`` on decoded boxes weighted by the target centerness, and
    the centerness BCE over the positives."""
    cls = torch.cat(list(cls_scores), dim=1).float()     # (B, P, C)
    reg = torch.cat(list(bbox_preds), dim=1).float()     # (B, P, D)
    ctr = torch.cat(list(centernesses), dim=1).float()   # (B, P)
    level_points = level_points or cfg.level_points(reg.device)
    t = fcos_targets(cfg, gt_boxes, gt_labels, gt_mask, level_points)
    pos = (t.labels >= 0) & (t.labels < cfg.num_classes)
    # normalisers over the global batch: summed over the ranks
    num_pos = global_count(pos.sum()).clamp(min=1).to(torch.float32)

    loss_cls = sigmoid_focal_loss(
        cls.reshape(-1, cfg.num_classes), t.labels.reshape(-1),
        avg_factor=num_pos)

    points = torch.cat(level_points[0])                  # (P, 2)
    coder = cfg.coder()
    pred_boxes = coder.decode(points[None], reg[..., :4])
    tgt_boxes = coder.decode(points[None], t.bbox_targets[..., :4])
    if cfg.box_version == 5:
        pred_boxes = torch.cat([pred_boxes, reg[..., 4:5]], -1)
        tgt_boxes = torch.cat([tgt_boxes, t.bbox_targets[..., 4:5]], -1)

    pos_ctr = torch.where(pos, t.centerness, 0.0)
    ctr_denorm = global_count(pos_ctr.sum()).clamp_min(1e-6)
    d = pred_boxes.shape[-1]
    # weight as (N, 1): broadcasts over coordinates for the L1 family;
    # reduce_box_weight collapses it to (N,) for the per-box losses
    loss_bbox = cfg.loss_bbox(
        pred_boxes.reshape(-1, d), tgt_boxes.reshape(-1, d),
        pos_ctr.reshape(-1)[:, None], avg_factor=ctr_denorm)

    ctr_bce = _bce_with_logits(ctr, t.centerness)
    loss_ctr = torch.where(pos, ctr_bce, 0.0).sum() / num_pos
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
            "loss_centerness": loss_ctr}


@torch.no_grad()
def fcos_predict(cfg: FCOSConfig, cls_scores, bbox_preds, centernesses,
                 level_points=None) -> NMSResult:
    """Scores sigmoid(cls) * sigmoid(centerness), an exact per-level top-k
    over the (point, class) pairs (``_select_level``; the JAX package takes
    an approximate two-stage one on the TPU), decode, NMS; one image at a
    time, every field of the result with a leading (B,) axis."""
    pts = (level_points or cfg.level_points(cls_scores[0].device))[0]
    coder = cfg.coder()
    per_image = []
    for i in range(cls_scores[0].shape[0]):
        parts = [
            _select_level(cfg, torch.sigmoid(scores[i])
                          * torch.sigmoid(ctr[i])[:, None],
                          reg[i], points, cfg.nms_pre)
            for scores, reg, ctr, points
            in zip(cls_scores, bbox_preds, centernesses, pts)
        ]
        top, labels, reg, points, valid = (
            torch.cat([p[j] for p in parts]) for j in range(5))
        boxes = coder.decode(points, reg[:, :4])
        if cfg.box_version == 5:
            boxes = torch.cat([boxes, reg[:, 4:5]], -1)
        per_image.append(sph_batched_nms(
            boxes, top, labels, iou_threshold=cfg.nms_iou_thr,
            max_num=cfg.max_per_img, nms_pre=cfg.nms_pre,
            backend=cfg.nms_backend, valid_mask=valid))
    return NMSResult(*(torch.stack(f) for f in zip(*per_image)))

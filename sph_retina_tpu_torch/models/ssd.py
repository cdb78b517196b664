"""SSD spherical detector: VGG16 + extras + per-level heads.

``SphSSDHead`` has ``box_version``-wide regression convs; classification is
a softmax over the classes and the background, trained by cross-entropy with
hard-negative mining at ``neg_pos_ratio`` (CE even where a ``loss_cls`` is
configured, as the original SSD head does), and the regression loss is
smooth-L1 on coder deltas or, with ``reg_decoded_bbox``, the configured
``loss_bbox`` on decoded boxes. Anchors use the SSD min/max-size scheme.

Hard-negative mining without a data-dependent size: every anchor's negative
loss is ranked (a stable descending sort, ties broken by index as in the
JAX package) and ranks below ``neg_pos_ratio`` times the positives of the
image are kept, so nothing waits for the device. The anchors x gt IoU of
the whole batch is one launch of the fused pairwise kernel at
``(B * max_gt, N)`` for the ``sph2pob_efficient`` backend
(``single_stage._batch_pairwise_iou``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..boxes.anchors import SphSSDAnchorGenerator
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coders import SphBBoxCoder
from ..boxes.nms import NMSResult, sph_batched_nms
from ..parallel import global_count
from .resnet import Conv2d, seeded_init_
from .single_stage import _batch_pairwise_iou, _select_level
from .vgg import SSDNeck, SSDVGG

SSD_OUT_CHANNELS = (512, 1024, 512, 256, 256, 256)


class SphSSDHead(nn.Module):
    """One 3x3 classification and one 3x3 regression conv a level; outputs
    flattened per level as (B, H*W*A, C+1) and (B, H*W*A, D) fp32, in the
    (h, w, anchor) order of the anchors."""

    def __init__(self, num_classes: int, box_version: int = 4,
                 in_channels: Sequence[int] = SSD_OUT_CHANNELS,
                 num_base_priors: Sequence[int] = (4, 6, 6, 6, 4, 4)):
        super().__init__()
        self.num_classes = num_classes
        self.box_version = box_version
        self.num_base_priors = tuple(num_base_priors)
        c_out = num_classes + 1  # softmax over the classes + background
        for i, (c, a) in enumerate(zip(in_channels, num_base_priors)):
            self.add_module(f"cls_conv_{i}", Conv2d(c, a * c_out, 3, 1, 1))
            self.add_module(f"reg_conv_{i}",
                            Conv2d(c, a * box_version, 3, 1, 1))

    def forward(self, feats):
        cls_scores, bbox_preds = [], []
        c_out = self.num_classes + 1
        for i, (x, a) in enumerate(zip(feats, self.num_base_priors)):
            b, _, h, w = x.shape
            cls = getattr(self, f"cls_conv_{i}")(x).float().permute(0, 2, 3, 1)
            reg = getattr(self, f"reg_conv_{i}")(x).float().permute(0, 2, 3, 1)
            cls_scores.append(cls.reshape(b, h * w * a, c_out))
            bbox_preds.append(reg.reshape(b, h * w * a, self.box_version))
        return cls_scores, bbox_preds


class SphSSD(nn.Module):
    """VGG16 trunk + SSD neck + head. ``remat=True`` checkpoints the whole
    trunk in a training forward with gradients (the JAX package's
    ``nn.remat(SSDVGG)``): VGG's full-resolution activations are recomputed
    in the backward pass instead of stored."""

    def __init__(self, num_classes: int, box_version: int = 4,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.backbone = SSDVGG()
        self.neck = SSDNeck(SSD_OUT_CHANNELS)
        self.bbox_head = SphSSDHead(num_classes=num_classes,
                                    box_version=box_version)

    def forward(self, images: torch.Tensor):
        """images: (B, H, W, 3) float, normalised -> (cls_scores,
        bbox_preds) per level."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        if self.remat and self.training and torch.is_grad_enabled():
            feats = checkpoint(self.backbone, x, use_reentrant=False)
        else:
            feats = self.backbone(x)
        return self.bbox_head(self.neck(feats))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """``seeded_init_`` with the L2Norm's scale at its initial 20."""
        seeded_init_(self, generator)
        self.backbone.l2_norm.weight.fill_(20.0)


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    num_classes: int
    box_version: int = 4
    img_size: tuple = (512, 1024)
    strides: tuple = (8, 16, 32, 64, 128, 256)
    neg_pos_ratio: float = 3.0
    smoothl1_beta: float = 1.0
    loss_bbox: Callable = None
    # with reg_decoded_bbox the regression loss sees decoded spherical boxes
    # against the matched gts through ``loss_bbox``; without it, smooth-L1
    # on coder deltas
    reg_decoded_bbox: bool = False
    # positive gather for decoded-box losses: the loss only sees the top-K
    # anchors of an image by weight; exact while positives <= K (dropped
    # terms have weight 0), else counted in metric_pos_dropped
    loss_pos_topk: int = 512
    assign_backend: str = "sph2pob_efficient"
    nms_pre: int = 1000
    score_thr: float = 0.02
    nms_iou_thr: float = 0.45
    max_per_img: int = 200
    nms_backend: str = "planar"

    def anchor_generator(self) -> SphSSDAnchorGenerator:
        # min/max sizes follow the SSD300 basesize ratio scheme scaled to
        # the chart height (ratio range 0.15-0.9, 0.07 below it)
        h = self.img_size[0]
        ratios = [0.07, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9]
        min_sizes = [h * r for r in ratios[:-1]]
        max_sizes = [h * r for r in ratios[1:]]
        level_ratios = ([2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0],
                        [2.0])
        return SphSSDAnchorGenerator(
            strides=list(self.strides), min_sizes=min_sizes,
            max_sizes=max_sizes, level_ratios=level_ratios,
            center_offset=0.5, box_version=self.box_version)

    def coder(self) -> SphBBoxCoder:
        means = (0.0,) * self.box_version
        stds = (0.1, 0.1, 0.2, 0.2) + ((0.1,) if self.box_version == 5 else ())
        return SphBBoxCoder(box_version=self.box_version, target_means=means,
                            target_stds=stds)

    def assigner(self) -> MaxIoUAssigner:
        return MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.5,
                              min_pos_iou=0.0, gt_max_assign_all=False)

    def featmap_sizes(self):
        h, w = self.img_size
        return [(-(-h // s), -(-w // s)) for s in self.strides]

    def level_anchors(self, device=None) -> list:
        return self.anchor_generator().grid_anchors(self.featmap_sizes(),
                                                    device)

    def flat_anchors(self, device=None) -> torch.Tensor:
        return torch.cat(self.level_anchors(device), dim=0)


def ssd_config(num_classes, img_size=(512, 1024), loss_bbox=None, **kw):
    from ..losses import smooth_l1_loss

    return SSDConfig(num_classes=num_classes, img_size=tuple(img_size),
                     loss_bbox=loss_bbox or smooth_l1_loss, **kw)


def ssd_loss(cfg: SSDConfig, cls_scores, bbox_preds, anchors, gt_boxes,
             gt_labels, gt_mask) -> dict:
    """Losses of one batch as 0-dim tensors: ``loss_cls`` (CE over the
    positives and the mined negatives), ``loss_bbox``, both over the
    batch's positives, and with the positive gather the gradient-free
    ``metric_pos_dropped``."""
    cls = torch.cat(list(cls_scores), dim=1).float()   # (B, N, C+1)
    reg = torch.cat(list(bbox_preds), dim=1).float()   # (B, N, D)
    b, n, d = reg.shape
    coder = cfg.coder()

    with torch.no_grad():
        overlaps = _batch_pairwise_iou(gt_boxes, anchors, cfg.assign_backend)
        res = cfg.assigner()(overlaps, gt_mask, gt_labels)
    pos = res.gt_inds > 0                                      # (B, N)
    neg = res.gt_inds == 0
    g = gt_boxes.shape[1]
    safe = (res.gt_inds - 1).clamp(0, g - 1).to(torch.int64)
    matched = gt_boxes.gather(1, safe[..., None].expand(-1, -1, d))
    labels = torch.where(pos, res.labels, cfg.num_classes).to(torch.int64)

    # CE over classes + background; each anchor's loss ranks the negatives
    ce = -F.log_softmax(cls, dim=-1).gather(-1, labels[..., None])[..., 0]
    num_pos = pos.sum(dim=-1)                                  # (B,)
    with torch.no_grad():
        neg_losses = torch.where(neg, ce, -1.0)
        order = torch.argsort(-neg_losses, dim=-1, stable=True)
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(n, device=order.device).expand(b, n))
        # truncated toward zero, as the JAX package's int cast
        num_neg = torch.minimum((cfg.neg_pos_ratio * num_pos).to(torch.int32),
                                neg.sum(dim=-1))
        neg_sel = neg & (rank < num_neg[:, None])
    loss_cls = torch.where(pos | neg_sel, ce, 0.0).sum()

    if cfg.reg_decoded_bbox:
        pred_boxes = coder.decode(anchors[None], reg)
        w = pos.to(torch.float32)
        k = min(cfg.loss_pos_topk, n) if cfg.loss_pos_topk else 0
        dropped = torch.zeros((), device=reg.device)
        if 0 < k < n:
            # exact while an image's positives <= k; a breach truncates the
            # regression loss and is counted in metric_pos_dropped
            dropped = (num_pos - k).clamp(min=0).sum().to(torch.float32)
            w, idx = torch.topk(w, k, dim=-1)
            pred_boxes = pred_boxes.gather(1, idx[..., None].expand(-1, -1, d))
            matched = matched.gather(1, idx[..., None].expand(-1, -1, d))
        loss_bbox = cfg.loss_bbox(
            pred_boxes.reshape(-1, d), matched.reshape(-1, d),
            w.reshape(-1)[:, None].expand(-1, d), reduction="sum")
    else:
        targets = coder.encode(anchors[None], matched)
        diff = (reg - targets).abs()
        sl1 = torch.where(diff < cfg.smoothl1_beta,
                          0.5 * diff * diff / cfg.smoothl1_beta,
                          diff - 0.5 * cfg.smoothl1_beta)
        loss_bbox = torch.where(pos[..., None], sl1, 0.0).sum()

    # positives of the global batch: summed over the ranks
    denom = global_count(num_pos.sum()).clamp(min=1).to(torch.float32)
    out = {"loss_cls": loss_cls / denom, "loss_bbox": loss_bbox / denom}
    if cfg.reg_decoded_bbox and cfg.loss_pos_topk:
        out["metric_pos_dropped"] = dropped
    return out


@torch.no_grad()
def ssd_predict(cfg: SSDConfig, cls_scores, bbox_preds,
                level_anchors) -> NMSResult:
    """Softmax (background dropped), per-level top-k, decode and NMS, one
    image at a time; every field of the result has a leading (B,) axis."""
    coder = cfg.coder()
    per_image = []
    for i in range(cls_scores[0].shape[0]):
        parts = [
            _select_level(cfg, torch.softmax(scores[i], dim=-1)[:, :-1],
                          deltas[i], priors, cfg.nms_pre)
            for scores, deltas, priors
            in zip(cls_scores, bbox_preds, level_anchors)
        ]
        top, labels, deltas, priors, valid = (
            torch.cat([p[j] for p in parts]) for j in range(5))
        per_image.append(sph_batched_nms(
            coder.decode(priors, deltas), top, labels,
            iou_threshold=cfg.nms_iou_thr, max_num=cfg.max_per_img,
            nms_pre=cfg.nms_pre, backend=cfg.nms_backend, valid_mask=valid))
    return NMSResult(*(torch.stack(f) for f in zip(*per_image)))

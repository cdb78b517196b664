"""Faster R-CNN spherical detector: RPN + RoIAlign + 2FC box head.

- RPN: a shared 3x3 conv, per-anchor sigmoid objectness and
  ``box_version`` deltas; proposals are a per-level top-k, decode and planar
  NMS (levels kept apart), ``num_proposals`` a image;
- RoI: spherical rois -> ERP-chart xyxy (the hbb cover of an RBFoV box) ->
  RoIAlign on the FPN's four finest levels -> Shared2FC head (softmax over
  the classes and the background, one box of deltas a roi).

Fixed shapes, as in the JAX package: proposals and sampled rois are
fixed-size masked tensors, and RoIAlign is two dense interpolation products
(hat-function weights) evaluated on all four levels, from which each roi
takes its own (mmdet SingleRoIExtractor's level mapping). The RPN
assignment is one launch of the pairwise kernel at (B * max_gt, anchors);
the RoI assignment one launch a image at (max_gt, proposals + max_gt),
where the JAX package calls the kernel's plain version (the candidates
differ per image, so its one-launch batch kernel does not apply there).

Layout: images come in as (B, H, W, 3), the FPN levels are NCHW inside, and
RoI features are (R, 7, 7, C), NHWC as in the JAX package, so that its Flax
``fc1`` kernel, transposed, is ``fc1.weight``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..boxes.anchors import SphAnchorGenerator
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coders import SphBBoxCoder
from ..boxes.nms import NMSResult, sph_batched_nms, sph_batched_soft_nms
from ..losses.focal_loss import _bce_with_logits
from ..ops.sph2pob_iou import sph2pob_iou_pairwise
from ..parallel import global_count
from .fpn import FPN
from .resnet import Conv2d, ResNet, seeded_init_
from .single_stage import _batch_pairwise_iou


# --------------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------------- #
class Linear(nn.Linear):
    """Dense layer with fp32 parameters that computes in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class SphRPNHead(nn.Module):
    def __init__(self, box_version: int = 4, in_channels: int = 256,
                 feat_channels: int = 256, num_base_priors: int = 3):
        super().__init__()
        self.box_version = box_version
        self.num_base_priors = num_base_priors
        self.rpn_conv = Conv2d(in_channels, feat_channels, 3, 1, 1)
        self.rpn_cls = Conv2d(feat_channels, num_base_priors, 1)
        self.rpn_reg = Conv2d(feat_channels, num_base_priors * box_version, 1)

    def forward(self, feats):
        """feats: (B, C, H, W) levels -> (cls_scores, bbox_preds), per level
        (B, H*W*A) and (B, H*W*A, box_version) fp32, in the (h, w, a) order
        of the anchors."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            b, _, h, w = x.shape
            n = h * w * self.num_base_priors
            t = F.relu(self.rpn_conv(x))
            cls_scores.append(
                self.rpn_cls(t).float().permute(0, 2, 3, 1).reshape(b, n))
            bbox_preds.append(self.rpn_reg(t).float().permute(0, 2, 3, 1)
                              .reshape(b, n, self.box_version))
        return cls_scores, bbox_preds


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int, box_version: int = 4,
                 in_channels: int = 256, fc_channels: int = 1024,
                 roi_size: int = 7, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Linear(roi_size * roi_size * in_channels, fc_channels)
        self.fc2 = Linear(fc_channels, fc_channels)
        self.fc_cls = Linear(fc_channels, num_classes + 1)
        self.fc_reg = Linear(fc_channels, box_version)

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats: (R, roi_size, roi_size, C) -> (R, C+1), (R, D) fp32."""
        x = roi_feats.reshape(roi_feats.shape[0], -1).to(self.dtype)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()


class SphFasterRCNN(nn.Module):
    """ResNet + FPN (from C2, five levels, the extra one on the last
    output); the RPN and the RoI head are reached through ``rpn`` and
    ``roi``."""

    def __init__(self, num_classes: int, box_version: int = 4,
                 depth: int = 50, dtype: torch.dtype = torch.bfloat16,
                 groups: int = 1, base_width: int = 64, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(0, 1, 2, 3),
                               groups=groups, base_width=base_width,
                               remat=remat)
        self.neck = FPN(self.backbone.out_channels, out_channels=256,
                        start_level=0, num_outs=5,
                        add_extra_convs="on_output")
        self.rpn_head = SphRPNHead(box_version=box_version)
        self.bbox_head = Shared2FCBBoxHead(num_classes=num_classes,
                                           box_version=box_version,
                                           dtype=dtype)

    def extract_feats(self, images: torch.Tensor):
        """images: (B, H, W, 3) float, normalised -> five (B, 256, h, w)
        levels in the working dtype."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        return self.neck(self.backbone(x))

    def rpn(self, feats):
        return self.rpn_head(feats)

    def roi(self, roi_feats):
        return self.bbox_head(roi_feats)

    def forward(self, images: torch.Tensor):
        feats = self.extract_feats(images)
        return self.rpn(feats), feats

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        seeded_init_(self, generator)


# --------------------------------------------------------------------------- #
# RoIAlign (SingleRoIExtractor semantics)
# --------------------------------------------------------------------------- #
def _hat_weights(coords: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear interpolation weights as a dense matrix: coords (..., S) in
    feature coordinates -> (..., S, size), row s the hat function
    max(0, 1 - |coord_s - i|), the two-tap bilinear weights with the edge
    clamp folded in by clipping the coordinate."""
    c = coords.clamp(0.0, size - 1.0)
    grid = torch.arange(size, dtype=coords.dtype, device=coords.device)
    return (1.0 - (c[..., None] - grid).abs()).clamp_min(0.0)


def roi_align(feat: torch.Tensor, rois_xyxy: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2):
    """RoIAlign on one feature map: (..., H, W, C) x (..., R, 4) ->
    (..., R, s, s, C), leading axes batched.

    Bilinear sampling as two dense interpolation products. The mean over
    the ``sampling_ratio`` sub-samples is linear in the weights, so it is
    folded into them; the wider spatial axis is contracted first (an ERP
    chart has W = 2H), and the chain stays in the feature dtype, as in the
    JAX package.
    """
    s, sr = out_size, sampling_ratio
    h, w = feat.shape[-3], feat.shape[-2]
    x1, y1, x2, y2 = (rois_xyxy[..., i] * spatial_scale for i in range(4))
    bw = (x2 - x1).clamp_min(1e-3) / s
    bh = (y2 - y1).clamp_min(1e-3) / s
    dev = rois_xyxy.device
    off = (torch.arange(s, device=dev)[:, None]
           + (torch.arange(sr, device=dev) + 0.5)[None, :] / sr).reshape(-1)
    gx = x1[..., None] + off * bw[..., None] - 0.5      # (..., R, s*sr)
    gy = y1[..., None] + off * bh[..., None] - 0.5
    lead = gx.shape[:-1]
    wy = _hat_weights(gy, h).reshape(*lead, s, sr, h).mean(-2)  # (..., R, s, H)
    wx = _hat_weights(gx, w).reshape(*lead, s, sr, w).mean(-2)  # (..., R, s, W)
    wy = wy.to(feat.dtype)
    wx = wx.to(feat.dtype)
    if w >= h:
        tmp = torch.einsum("...rtw,...hwc->...rthc", wx, feat)
        return torch.einsum("...rsh,...rthc->...rstc", wy, tmp)
    tmp = torch.einsum("...rsh,...hwc->...rswc", wy, feat)
    return torch.einsum("...rtw,...rswc->...rstc", wx, tmp)


def multilevel_roi_align(feats: Sequence[torch.Tensor],
                         rois_xyxy: torch.Tensor, strides=(4, 8, 16, 32),
                         out_size: int = 7, finest_scale: float = 56.0):
    """RoIAlign over FPN levels (each (..., H, W, C)) with mmdet's level
    mapping, ``floor(log2(sqrt(area) / finest_scale + 1e-6))`` clamped to
    the levels: every roi is evaluated on every level, then takes its
    own."""
    w = rois_xyxy[..., 2] - rois_xyxy[..., 0]
    h = rois_xyxy[..., 3] - rois_xyxy[..., 1]
    scale = torch.sqrt((w * h).clamp_min(1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    lvl = lvl.clamp(0, len(strides) - 1).to(torch.int64)
    # (L, ..., R, s, s, C)
    per_level = torch.stack([roi_align(f, rois_xyxy, out_size, 1.0 / s)
                             for f, s in zip(feats, strides)])
    idx = lvl[None, ..., None, None, None].expand(1, *per_level.shape[1:])
    return per_level.gather(0, idx)[0]


# --------------------------------------------------------------------------- #
# config + functional paths
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    num_classes: int
    box_version: int = 4
    img_size: tuple = (512, 1024)
    strides: tuple = (4, 8, 16, 32, 64)
    num_proposals: int = 512       # kept per image after RPN NMS
    num_rois: int = 256            # sampled rois per image for training
    pos_fraction: float = 0.25
    sampler_type: str = "random"   # "random" | "ohem" (hard-example mining)
    assign_backend: str = "sph2pob_efficient"
    # second-stage regression loss: None -> L1 on coder deltas; with
    # reg_decoded_bbox, an IoU-family loss on decoded boxes
    loss_bbox: Callable | None = None
    reg_decoded_bbox: bool = False
    rpn_nms_iou: float = 0.7
    rpn_nms_pre: int = 1000
    # Upper bound on the NMS candidate set across levels: the (k, k) IoU
    # matrix is O(k^2) a image, so the per-level top-k survivors are
    # re-ranked to this cap before suppression.
    rpn_matrix_cap: int = 2048
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_per_img: int = 100
    nms_backend: str = "planar"
    # soft-NMS for the final detections only; the RPN keeps hard NMS
    nms_type: str = "nms"
    soft_method: str = "linear"
    soft_sigma: float = 0.5
    soft_min_score: float = 1e-3

    def anchor_generator(self) -> SphAnchorGenerator:
        return SphAnchorGenerator(strides=list(self.strides),
                                  ratios=[0.5, 1.0, 2.0], scales=[8.0],
                                  box_version=self.box_version)

    def rpn_coder(self) -> SphBBoxCoder:
        return SphBBoxCoder(box_version=self.box_version)

    def rcnn_coder(self) -> SphBBoxCoder:
        stds = (0.1, 0.1, 0.2, 0.2) + ((0.1,) if self.box_version == 5 else ())
        return SphBBoxCoder(box_version=self.box_version, target_stds=stds)

    def rpn_assigner(self) -> MaxIoUAssigner:
        return MaxIoUAssigner(pos_iou_thr=0.7, neg_iou_thr=0.3,
                              min_pos_iou=0.3)

    def rcnn_assigner(self) -> MaxIoUAssigner:
        return MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.5,
                              min_pos_iou=0.5, match_low_quality=False)

    def featmap_sizes(self):
        h, w = self.img_size
        return [(-(-h // s), -(-w // s)) for s in self.strides]

    def level_anchors(self, device=None) -> list:
        return self.anchor_generator().grid_anchors(self.featmap_sizes(),
                                                    device)

    def flat_anchors(self, device=None) -> torch.Tensor:
        return torch.cat(self.level_anchors(device), dim=0)


def faster_rcnn_config(num_classes, img_size=(512, 1024), **kw):
    return FasterRCNNConfig(num_classes=num_classes, img_size=tuple(img_size),
                            **kw)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, descending,
    the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _sph_to_chart_xyxy(boxes, img_size, box_version):
    """Spherical degrees -> chart xyxy; RBFoV takes the hbb cover."""
    h, w = img_size
    sx, sy = w / 360.0, h / 180.0
    cx, cy = boxes[..., 0] * sx, boxes[..., 1] * sy
    bw, bh = boxes[..., 2] * sx, boxes[..., 3] * sy
    if box_version == 5:
        ang = torch.deg2rad(boxes[..., 4])
        ca, sa = torch.cos(ang).abs(), torch.sin(ang).abs()
        bw, bh = ca * bw + sa * bh, sa * bw + ca * bh
    return torch.stack([(cx - bw / 2).clamp(0, w), (cy - bh / 2).clamp(0, h),
                        (cx + bw / 2).clamp(0, w), (cy + bh / 2).clamp(0, h)],
                       dim=-1)


def _stack(results: list) -> NMSResult:
    return NMSResult(*(torch.stack(f) for f in zip(*results)))


@torch.no_grad()
def rpn_proposals(cfg: FasterRCNNConfig, rpn_cls, rpn_reg,
                  level_anchors=None):
    """Fixed-size proposals a image: (B, P, D) boxes, (B, P) scores and
    validity. The per-level top-k is exact (the JAX package takes
    ``approx_max_k`` on the TPU); the NMS runs one image at a time."""
    if level_anchors is None:
        level_anchors = cfg.level_anchors(rpn_cls[0].device)
    coder = cfg.rpn_coder()
    tops, boxes, ids = [], [], []
    for lvl, (logits, deltas, priors) in enumerate(
            zip(rpn_cls, rpn_reg, level_anchors)):
        k = min(cfg.rpn_nms_pre, logits.shape[1])
        top, idx = _top_k(torch.sigmoid(logits.float()), k)   # (B, k)
        d = deltas.shape[-1]
        picked = deltas.float().gather(1, idx[..., None].expand(-1, -1, d))
        boxes.append(coder.decode(priors[idx], picked))
        tops.append(top)
        ids.append(torch.full((k,), lvl, dtype=torch.int32,
                              device=logits.device))
    boxes, scores, ids = torch.cat(boxes, 1), torch.cat(tops, 1), torch.cat(ids)
    res = _stack([sph_batched_nms(
        boxes[b], scores[b], ids, iou_threshold=cfg.rpn_nms_iou,
        max_num=cfg.num_proposals,
        nms_pre=min(cfg.rpn_matrix_cap, scores.shape[1]),
        backend=cfg.nms_backend) for b in range(scores.shape[0])])
    return res.boxes, res.scores, res.valid


def rpn_loss(cfg: FasterRCNNConfig, rpn_cls, rpn_reg, gt_boxes, gt_mask,
             anchors=None) -> dict:
    """Sigmoid BCE over positive and negative anchors (averaged over them),
    L1 on the deltas of the positives (averaged over those). The anchors x
    gts IoU of the whole batch is one launch of the pairwise kernel."""
    if anchors is None:
        anchors = cfg.flat_anchors(gt_boxes.device)
    cls = torch.cat(list(rpn_cls), dim=1).float()   # (B, N)
    reg = torch.cat(list(rpn_reg), dim=1).float()   # (B, N, D)
    with torch.no_grad():
        overlaps = _batch_pairwise_iou(gt_boxes, anchors, cfg.assign_backend)
        res = cfg.rpn_assigner()(overlaps, gt_mask)
        pos = res.gt_inds > 0
        neg = res.gt_inds == 0
        g, d = gt_boxes.shape[1:]
        safe = (res.gt_inds - 1).clamp(0, g - 1).to(torch.int64)
        matched = gt_boxes.gather(1, safe[..., None].expand(-1, -1, d))
        targets = cfg.rpn_coder().encode(anchors[None], matched)
    bce = _bce_with_logits(cls, pos.to(torch.float32))
    loss_cls = torch.where(pos | neg, bce, 0.0).sum()
    l1 = (reg - targets).abs().sum(-1)
    loss_reg = torch.where(pos, l1, 0.0).sum()
    # normalisers over the global batch: summed over the ranks
    return {"loss_rpn_cls":
            loss_cls / global_count((pos | neg).sum()).clamp_min(1),
            "loss_rpn_bbox": loss_reg / global_count(pos.sum()).clamp_min(1)}


class RoITargets(NamedTuple):
    rois: torch.Tensor          # (B, R, D) spherical degrees
    labels: torch.Tensor        # (B, R) int32 in [0, C]; C = background
    reg_targets: torch.Tensor   # (B, R, D)
    weights: torch.Tensor       # (B, R) sample mask
    pos_mask: torch.Tensor      # (B, R) bool


@torch.no_grad()
def sample_rois(cfg: FasterRCNNConfig, generator: torch.Generator | None,
                proposals, prop_valid, gt_boxes, gt_labels, gt_mask,
                hardness_fn: Callable[[Any, Any], torch.Tensor] | None = None
                ) -> RoITargets:
    """Assign and subsample proposals, the gt boxes appended as proposals.

    Each group (positives: at most ``num_rois * pos_fraction``; negatives:
    the rest of ``num_rois``) keeps its members of highest priority: random
    ones drawn from ``generator``, or with ``hardness_fn(cand (B, K, D),
    labels (B, K)) -> (B, K)`` their loss from a head forward (OHEM, the
    hardest first). No gradient flows through the result.
    """
    b, g, d = gt_boxes.shape
    cand = torch.cat([proposals, gt_boxes], dim=1)          # (B, K, D)
    cand_valid = torch.cat([prop_valid, gt_mask], dim=1)
    # one launch of the pairwise kernel a image: (G, K)
    overlaps = torch.stack([
        sph2pob_iou_pairwise(gt_boxes[i].float().contiguous(),
                             cand[i].float().contiguous())
        for i in range(b)])
    overlaps = torch.where(cand_valid[:, None, :], overlaps, -1.0)
    res = cfg.rcnn_assigner()(overlaps, gt_mask, gt_labels)
    pos = (res.gt_inds > 0) & cand_valid
    neg = (res.gt_inds == 0) & cand_valid
    full_labels = torch.where(pos, res.labels, cfg.num_classes).to(torch.int32)
    hardness = None if hardness_fn is None else hardness_fn(cand, full_labels)

    def pick(mask, k):
        prio = hardness if hardness is not None else torch.rand(
            mask.shape, generator=generator, device=mask.device)
        _, idx = _top_k(torch.where(mask, prio, -torch.inf), k)
        return idx, mask.gather(1, idx)

    num_pos_max = int(cfg.num_rois * cfg.pos_fraction)
    pos_idx, pos_keep = pick(pos, num_pos_max)
    neg_idx, neg_keep = pick(neg, cfg.num_rois - num_pos_max)
    idx = torch.cat([pos_idx, neg_idx], dim=1)
    keep = torch.cat([pos_keep, neg_keep], dim=1)
    pos_sel = torch.cat([pos_keep, torch.zeros_like(neg_keep)], dim=1)

    rois = cand.gather(1, idx[..., None].expand(-1, -1, d))
    safe = (res.gt_inds.gather(1, idx) - 1).clamp(0, g - 1).to(torch.int64)
    matched = gt_boxes.gather(1, safe[..., None].expand(-1, -1, d))
    reg_t = cfg.rcnn_coder().encode(rois, matched)
    labels = torch.where(pos_sel, full_labels.gather(1, idx), cfg.num_classes)
    return RoITargets(rois, labels.to(torch.int32), reg_t,
                      keep.to(torch.float32), pos_sel)


def roi_features(cfg: FasterRCNNConfig, feats, rois):
    """(B, R, D) spherical rois -> (B, R, 7, 7, C) features of the FPN's
    four finest levels (``feats``: NCHW levels)."""
    xyxy = _sph_to_chart_xyxy(rois, cfg.img_size, cfg.box_version)
    return multilevel_roi_align([f.permute(0, 2, 3, 1) for f in feats[:4]],
                                xyxy, strides=cfg.strides[:4])


def rcnn_loss(cfg: FasterRCNNConfig, cls_logits, reg_pred,
              targets: RoITargets) -> dict:
    """cls_logits (B*R, C+1), reg_pred (B*R, D): cross-entropy over the
    sampled rois, regression over the positives (L1 on deltas, or with
    ``reg_decoded_bbox`` ``cfg.loss_bbox`` on decoded boxes; decoding the
    encoded target gives the matched gt back)."""
    labels = targets.labels.reshape(-1).to(torch.int64)
    w = targets.weights.reshape(-1)
    pos = targets.pos_mask.reshape(-1)
    logp = torch.log_softmax(cls_logits.float(), dim=-1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    # normalisers over the global batch: summed over the ranks
    loss_cls = (ce * w).sum() / global_count(w.sum()).clamp_min(1.0)
    d = reg_pred.shape[-1]
    num_pos = global_count(pos.sum()).clamp_min(1).to(torch.float32)
    reg_t = targets.reg_targets.reshape(-1, d)
    if cfg.reg_decoded_bbox and cfg.loss_bbox is not None:
        coder = cfg.rcnn_coder()
        rois = targets.rois.reshape(-1, d)
        pred_boxes = coder.decode(rois, reg_pred)
        loss_reg = cfg.loss_bbox(
            pred_boxes, coder.decode(rois, reg_t),
            pos.to(torch.float32)[:, None].expand_as(pred_boxes),
            avg_factor=num_pos)
    else:
        l1 = (reg_pred - reg_t).abs().sum(-1)
        loss_reg = torch.where(pos, l1, 0.0).sum() / num_pos
    return {"loss_cls": loss_cls, "loss_bbox": loss_reg}


@torch.no_grad()
def rcnn_predict(cfg: FasterRCNNConfig, cls_logits, reg_pred, rois,
                 roi_valid) -> NMSResult:
    """Second-stage decode + per-class NMS (soft-NMS where ``nms_type`` is
    ``soft_nms``), one image at a time: cls_logits (B, P, C+1), reg_pred
    and rois (B, P, D) -> results with a leading (B,) axis."""
    coder = cfg.rcnn_coder()
    per_image = []
    for logits, reg, roi, valid in zip(cls_logits, reg_pred, rois, roi_valid):
        probs = torch.softmax(logits.float(), dim=-1)[:, :-1]   # (P, C)
        boxes = coder.decode(roi, reg)
        p, c = probs.shape
        flat = torch.where(probs > cfg.score_thr, probs, -1.0).reshape(-1)
        flat = torch.where(valid.repeat_interleave(c), flat, -1.0)
        k = min(cfg.rpn_nms_pre, p * c)
        top, idx = _top_k(flat, k)
        labels = (idx % c).to(torch.int32)
        kw = dict(iou_threshold=cfg.nms_iou_thr, max_num=cfg.max_per_img,
                  nms_pre=k, backend=cfg.nms_backend, valid_mask=top > 0)
        if cfg.nms_type == "soft_nms":
            per_image.append(sph_batched_soft_nms(
                boxes[idx // c], top, labels, sigma=cfg.soft_sigma,
                min_score=cfg.soft_min_score, method=cfg.soft_method, **kw))
        else:
            per_image.append(sph_batched_nms(boxes[idx // c], top, labels,
                                             **kw))
    return _stack(per_image)

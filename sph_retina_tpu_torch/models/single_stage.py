"""Single-stage spherical detector: module + functional train/test paths.

- the network (backbone -> FPN -> head) is one ``nn.Module``; images come in
  as (B, H, W, 3), as the JAX package takes them, and are viewed as
  channels-last NCHW inside;
- target assignment and loss are pure functions over the padded batch (gt
  boxes padded to ``max_gt`` with a mask). The anchors x gt IoU matrix of the
  whole batch is ONE launch of the pairwise kernel at ``(B * max_gt, N)``
  for the ``sph2pob_efficient`` backend (the other backends go through
  ``sph_overlaps``, plain PyTorch);
  every count (positives, dropped positives) stays a 0-dim tensor on the
  device, and nothing is indexed by a mask whose size the host would have to
  learn, so a training step never waits for the device;
- decode + NMS is a pure function over the head outputs, one image at a
  time (the (k, k) IoU matrix of each image is one kernel launch).

Loss semantics follow mmdet ``AnchorHead.loss``: focal classification over
pos+neg anchors with avg_factor = total positives, regression over positives
(optionally on decoded boxes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..boxes.anchors import SphAnchorGenerator
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coders import SphBBoxCoder
from ..boxes.nms import NMSResult, sph_batched_nms, sph_batched_soft_nms
from ..iou.api import canonical_backend, sph_overlaps
from ..losses import sigmoid_focal_loss, sph_l1_loss
from ..ops.sph2pob_iou import sph2pob_iou_pairwise
from ..parallel import global_count
from ..parallel.distributed import group_gather, group_sum
from .fpn import FPN
from .heads.retina_head import SphRetinaHead
from .resnet import ResNet, seeded_init_


class SphRetinaNet(nn.Module):
    """ResNet + FPN + RetinaHead; returns per-level flattened outputs."""

    def __init__(self, num_classes: int, box_version: int = 4,
                 depth: int = 50, feat_channels: int = 256,
                 num_base_priors: int = 9, dtype: torch.dtype = torch.bfloat16,
                 groups: int = 1, base_width: int = 64, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(0, 1, 2, 3),
                               groups=groups, base_width=base_width,
                               remat=remat)
        self.neck = FPN(self.backbone.out_channels, out_channels=feat_channels,
                        start_level=1, num_outs=5)
        self.bbox_head = SphRetinaHead(
            num_classes=num_classes, box_version=box_version,
            in_channels=feat_channels, feat_channels=feat_channels,
            num_base_priors=num_base_priors)

    def forward(self, images: torch.Tensor):
        """images: (B, H, W, 3) float, normalised -> (cls_scores, bbox_preds),
        per level (B, H*W*A, num_classes) and (B, H*W*A, box_version) fp32."""
        # (B, H, W, 3) -> NCHW view with channels-last strides: no copy
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        return self.bbox_head(self.neck(self.backbone(x)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random initialisation from an explicit generator
        (``seeded_init_``) with the focal prior on ``retina_cls``'s bias."""
        seeded_init_(self, generator)
        self.bbox_head.retina_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Bundles the declarative pieces the configs spread over several dicts."""

    num_classes: int
    box_version: int = 4
    img_size: tuple = (512, 1024)  # (H, W)
    anchor_generator: SphAnchorGenerator = None
    bbox_coder: SphBBoxCoder = None
    assigner: MaxIoUAssigner = None
    loss_bbox: Callable = None
    reg_decoded_bbox: bool = False
    assign_backend: str = "sph2pob_efficient"
    # test cfg
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_per_img: int = 100
    nms_backend: str = "planar"
    # nms=dict(type='soft_nms', ...) selects score-decay suppression
    nms_type: str = "nms"
    soft_method: str = "linear"
    soft_sigma: float = 0.5
    soft_min_score: float = 1e-3
    # focal loss
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    # Decoded-box regression losses (reg_decoded_bbox) run per anchor, but
    # only positives carry weight (~10^2 of ~10^5 per image). Gathering the
    # top-K anchors by bbox weight before the loss keeps the loss math off
    # the zero-weight anchors — exact whenever positives <= K, since dropped
    # terms have weight 0 and the avg_factor is unchanged. K is per-image.
    # Set 0 to disable (full per-anchor loss).
    loss_pos_topk: int = 1024

    def featmap_sizes(self):
        # ceil: stride-2 convs output ceil(in/2), so tiny inputs still give
        # one cell on the coarsest levels
        h, w = self.img_size
        return [(-(-h // s), -(-w // s)) for s in self.anchor_generator.strides]

    def flat_anchors(self, device=None):
        return self.anchor_generator.flat_anchors(self.featmap_sizes(), device)


def retina_config(num_classes: int, box_version: int = 4, img_size=(512, 1024),
                  loss_bbox: Callable | None = None,
                  reg_decoded_bbox: bool = False, **overrides) -> DetectorConfig:
    """The defaults of the base config ``sph_retinanet_r50_fpn``."""
    return DetectorConfig(
        num_classes=num_classes,
        box_version=box_version,
        img_size=img_size,
        anchor_generator=SphAnchorGenerator(
            strides=[8, 16, 32, 64, 128],
            ratios=[0.5, 1.0, 2.0],
            octave_base_scale=4,
            scales_per_octave=3,
            box_version=box_version,
        ),
        bbox_coder=SphBBoxCoder(box_version=box_version),
        assigner=MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4,
                                min_pos_iou=0.0),
        loss_bbox=loss_bbox if loss_bbox is not None else sph_l1_loss,
        reg_decoded_bbox=reg_decoded_bbox,
        **overrides,
    )


# --------------------------------------------------------------------------- #
# functional training path
# --------------------------------------------------------------------------- #
class AnchorTargets(NamedTuple):
    labels: torch.Tensor          # (B, N) int32 in [0, num_classes]; C = bg
    label_weights: torch.Tensor   # (B, N)
    bbox_targets: torch.Tensor    # (B, N, D)
    bbox_weights: torch.Tensor    # (B, N)
    num_pos: torch.Tensor         # () total positives in batch


def _batch_pairwise_iou(gt: torch.Tensor, anchors: torch.Tensor, backend: str):
    """(B, G, D) x (N, D) -> (B, G, N): for ``sph2pob_efficient`` one launch
    of the fused pairwise kernel (its plain version on CPU tensors); every
    other backend through ``sph_overlaps``, plain PyTorch on the tensors'
    device (``kent`` converts each side to Kent parameters once)."""
    b, g, d = gt.shape
    flat = gt.reshape(b * g, d).contiguous()
    if canonical_backend(backend) == "sph2pob_efficient":
        iou = sph2pob_iou_pairwise(flat, anchors.contiguous())
    else:
        iou = sph_overlaps(flat, anchors, backend)
    return iou.reshape(b, g, anchors.shape[0])


@torch.no_grad()
def anchor_targets(
    cfg: DetectorConfig,
    anchors: torch.Tensor,        # (N, D)
    gt_boxes: torch.Tensor,       # (B, G, D) degrees, padded
    gt_labels: torch.Tensor,      # (B, G) integer
    gt_mask: torch.Tensor,        # (B, G) bool
    group=None,
) -> AnchorTargets:
    """Assignment and regression targets of the whole batch at once; no
    gradient flows into them. ``anchors`` may be one "space" rank's own
    (``group``: the ranks that hold the others, whose overlaps the
    assigner's low-quality rescue reads)."""
    overlaps = _batch_pairwise_iou(gt_boxes, anchors, cfg.assign_backend)
    res = cfg.assigner(overlaps, gt_mask, gt_labels, group=group)
    pos = res.gt_inds > 0
    neg = res.gt_inds == 0
    g, d = gt_boxes.shape[1:]
    safe = (res.gt_inds - 1).clamp(0, g - 1).to(torch.int64)     # (B, N)
    matched = gt_boxes.gather(1, safe[..., None].expand(-1, -1, d))
    if cfg.reg_decoded_bbox:
        targets = matched
    else:
        targets = cfg.bbox_coder.encode(anchors[None], matched)
    labels = torch.where(pos, res.labels, cfg.num_classes).to(torch.int32)
    return AnchorTargets(
        labels,
        (pos | neg).to(torch.float32),
        torch.where(pos[..., None], targets, 0.0),
        pos.to(torch.float32),
        pos.sum(),
    )


def _pos_gather(weights: torch.Tensor, k: int, group=None,
                rows: torch.Tensor | None = None) -> tuple:
    """The ``k`` rows of the highest ``weights``, ties to the lower row, as
    ``jax.lax.top_k`` keeps them: their indices and weights. Over the ranks
    of a split head (``group``; ``rows``: each local row's place among one
    process's), the ranks keep one process's ``k`` rows together: each takes
    its local top ``k`` (a local row's order is its place's), the ranks'
    are gathered (S x ``k`` weights and places), and the weights of the
    rows that are not among the ``k`` first of them all are set to 0."""
    idx = torch.sort(weights, descending=True, stable=True).indices[:k]
    weights = weights[idx]
    if group is None or dist.get_world_size(group) == 1:
        return idx, weights
    pad = k - idx.numel()
    every = group_gather(torch.stack([
        F.pad(weights.double(), (0, pad), value=-math.inf),
        F.pad(rows[idx].double(), (0, pad), value=math.inf)]), group)
    value, place = every[:, 0].reshape(-1), every[:, 1].reshape(-1)
    order = torch.sort(place, stable=True).indices
    order = order[torch.sort(value[order], descending=True,
                             stable=True).indices]
    kept = torch.zeros_like(value, dtype=torch.bool)
    kept[order[:k]] = True
    mine = kept.reshape(-1, k)[dist.get_rank(group), :idx.numel()]
    return idx, torch.where(mine, weights, 0.0)


def retina_loss(
    cfg: DetectorConfig,
    cls_scores: Sequence[torch.Tensor],   # per level (B, n_l, C)
    bbox_preds: Sequence[torch.Tensor],   # per level (B, n_l, D)
    anchors: torch.Tensor,                # (N, D) flat over levels
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    group=None,
    anchor_index: torch.Tensor | None = None,
) -> dict:
    """Losses of one batch as 0-dim tensors: ``loss_cls``, ``loss_bbox`` and,
    where the positive gather is on, the gradient-free count
    ``metric_pos_dropped``.

    On a head split over "space" (``group``: its ranks), the outputs and
    ``anchors`` are this rank's own (``anchor_index``: their places among
    one process's) and the loss is its part of the sum. The positive gather
    keeps one process's rows over the ranks together (``_pos_gather``), and
    the group's first rank reports ``metric_pos_dropped``."""
    cls = torch.cat(list(cls_scores), dim=1).float()   # (B, N, C)
    reg = torch.cat(list(bbox_preds), dim=1).float()   # (B, N, D)
    t = anchor_targets(cfg, anchors, gt_boxes, gt_labels, gt_mask, group)
    # positives of the global batch: summed over the ranks
    num_total = global_count(t.num_pos).clamp(min=1).to(torch.float32)

    loss_cls = sigmoid_focal_loss(
        cls.reshape(-1, cfg.num_classes),
        t.labels.reshape(-1),
        t.label_weights.reshape(-1),
        gamma=cfg.focal_gamma,
        alpha=cfg.focal_alpha,
        avg_factor=num_total,
    )

    b, n, d = reg.shape
    if cfg.reg_decoded_bbox:
        preds = cfg.bbox_coder.decode(anchors[None], reg).reshape(-1, d)
        targets = t.bbox_targets.reshape(-1, d)
        weights = t.bbox_weights.reshape(-1)
        pos_dropped = None
        # one process's anchors: every rank's on a split head
        n_all = n if group is None else cfg.anchor_generator.num_base_anchors \
            * sum(h * w for h, w in cfg.featmap_sizes())
        if 0 < cfg.loss_pos_topk < n_all:
            # Positive-gather: the loss only sees the K highest-weight
            # anchors — exact only while positives <= K. A breach truncates
            # the regression loss, so it is surfaced as metric_pos_dropped
            # in the logged metrics (0 in any healthy run; excluded from the
            # optimised total).
            k = b * cfg.loss_pos_topk
            pos_dropped = (group_sum((weights > 0).sum(), group) - k).clamp(
                min=0).to(torch.float32)
            rows = None
            if group is not None:
                rows = (torch.arange(b, device=reg.device)[:, None] * n_all
                        + anchor_index).reshape(-1)
                if dist.get_rank(group) > 0:
                    pos_dropped = torch.zeros_like(pos_dropped)
            idx, weights = _pos_gather(weights, k, group, rows)
            preds = preds[idx]
            targets = targets[idx]
        loss_bbox = cfg.loss_bbox(preds, targets, weights,
                                  avg_factor=num_total)
        if pos_dropped is not None:
            return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
                    "metric_pos_dropped": pos_dropped}
    else:
        loss_bbox = cfg.loss_bbox(
            reg.reshape(-1, d),
            t.bbox_targets.reshape(-1, d),
            t.bbox_weights.reshape(-1)[:, None].expand(-1, d),
            avg_factor=num_total,
        )
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}


# --------------------------------------------------------------------------- #
# functional inference path
# --------------------------------------------------------------------------- #
def _select_level(cfg, scores, deltas, priors, k):
    """Per-level score filtering + exact top-k over the (anchor, class)
    pairs. Returns (scores, labels, deltas, priors, valid) of k rows; rows
    below ``score_thr`` are invalid. Equal scores at the k-th place are
    broken as ``torch.topk`` breaks them."""
    n, c = scores.shape
    k = min(k, n * c)
    flat = torch.where(scores > cfg.score_thr, scores, -1.0).reshape(-1)
    top, idx = torch.topk(flat, k)
    anchor_idx = idx // c
    label = (idx % c).to(torch.int32)
    return top, label, deltas[anchor_idx], priors[anchor_idx], top > 0.0


def retina_predict(
    cfg: DetectorConfig,
    cls_scores: Sequence[torch.Tensor],
    bbox_preds: Sequence[torch.Tensor],
    level_anchors: Sequence[torch.Tensor],
) -> NMSResult:
    """Decode + per-class NMS (soft-NMS where ``cfg.nms_type`` is
    ``soft_nms``); returns fixed-size results stacked over the batch: every
    field has a leading (B,) axis."""
    per_image = []
    for b in range(cls_scores[0].shape[0]):
        parts = [
            _select_level(cfg, torch.sigmoid(scores[b]), deltas[b], priors,
                          cfg.nms_pre)
            for scores, deltas, priors
            in zip(cls_scores, bbox_preds, level_anchors)
        ]
        top, labels, deltas, priors, valid = (
            torch.cat([p[i] for p in parts]) for i in range(5))
        boxes = cfg.bbox_coder.decode(priors, deltas)
        kw = dict(iou_threshold=cfg.nms_iou_thr, max_num=cfg.max_per_img,
                  nms_pre=cfg.nms_pre, backend=cfg.nms_backend,
                  valid_mask=valid)
        if cfg.nms_type == "soft_nms":
            per_image.append(sph_batched_soft_nms(
                boxes, top, labels, sigma=cfg.soft_sigma,
                min_score=cfg.soft_min_score, method=cfg.soft_method, **kw))
        else:
            per_image.append(sph_batched_nms(boxes, top, labels, **kw))
    return NMSResult(*(torch.stack(f) for f in zip(*per_image)))

"""Single-stage spherical detector: module + functional inference path.

- the network (backbone -> FPN -> head) is one ``nn.Module``; images come in
  as (B, H, W, 3), as the JAX package takes them, and are viewed as
  channels-last NCHW inside;
- decode + NMS is a pure function over the head outputs, one image at a
  time (the (k, k) IoU matrix of each image is one kernel launch).

The training half (anchor targets, losses) is not part of this package yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from ..boxes.anchors import SphAnchorGenerator
from ..boxes.coders import SphBBoxCoder
from ..boxes.nms import NMSResult, sph_batched_nms
from .fpn import FPN
from .heads.retina_head import SphRetinaHead
from .resnet import ResNet


class SphRetinaNet(nn.Module):
    """ResNet + FPN + RetinaHead; returns per-level flattened outputs."""

    def __init__(self, num_classes: int, box_version: int = 4,
                 depth: int = 50, feat_channels: int = 256,
                 num_base_priors: int = 9, dtype: torch.dtype = torch.bfloat16,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet(depth=depth, out_indices=(0, 1, 2, 3),
                               groups=groups, base_width=base_width)
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
        """Random initialisation from an explicit generator: conv kernels
        N(0, 1/fan_in), biases 0 except the focal prior of ``retina_cls``,
        batch norms at identity."""
        for name, p in self.named_parameters():
            if p.ndim == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(fan_in))
            elif name.endswith("bias"):
                p.zero_()
            else:  # batch-norm scale
                p.fill_(1.0)
        self.bbox_head.retina_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))
        for name, b in self.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Bundles the declarative pieces the configs spread over several dicts
    (the inference half; training fields are not part of this package yet)."""

    num_classes: int
    box_version: int = 4
    img_size: tuple = (512, 1024)  # (H, W)
    anchor_generator: SphAnchorGenerator = None
    bbox_coder: SphBBoxCoder = None
    # test cfg
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_per_img: int = 100
    nms_backend: str = "planar"
    nms_type: str = "nms"

    def featmap_sizes(self):
        # ceil: stride-2 convs output ceil(in/2), so tiny inputs still give
        # one cell on the coarsest levels
        h, w = self.img_size
        return [(-(-h // s), -(-w // s)) for s in self.anchor_generator.strides]

    def flat_anchors(self, device=None):
        return self.anchor_generator.flat_anchors(self.featmap_sizes(), device)


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
    """Decode + per-class NMS; returns fixed-size results stacked over the
    batch: every field has a leading (B,) axis."""
    if cfg.nms_type != "nms":
        raise NotImplementedError(
            f"test_cfg.nms.type={cfg.nms_type!r}: only plain 'nms' is "
            "available in this package yet")
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
        per_image.append(sph_batched_nms(
            boxes, top, labels,
            iou_threshold=cfg.nms_iou_thr,
            max_num=cfg.max_per_img,
            nms_pre=cfg.nms_pre,
            backend=cfg.nms_backend,
            valid_mask=valid,
        ))
    return NMSResult(*(torch.stack(f) for f in zip(*per_image)))

"""RetinaNet head with ``box_version``-wide regression.

Four stacked 3x3 convs per tower shared over the levels, a focal-init
classification bias, and a regression conv that emits ``A * box_version``
channels (5 for rotated boxes).

Outputs are returned flattened per level as (B, H*W*A, C) fp32 — the layout
every downstream consumer (decode, loss) wants. A convolution here yields
(B, A*C, H, W), so each output is permuted to (B, H, W, A*C) before the
reshape: without that, predictions and anchors fall out of step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..resnet import Conv2d


class SphRetinaHead(nn.Module):
    # each anchor's outputs and loss need only its own cell's neighbourhood:
    # the head splits over "space" (``parallel/sharding.py``)
    splits_over_space = True

    def __init__(self, num_classes: int, box_version: int = 4,
                 in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, num_base_priors: int = 9):
        super().__init__()
        self.num_classes = num_classes
        self.box_version = box_version
        self.stacked_convs = stacked_convs
        self.num_base_priors = num_base_priors
        for i in range(stacked_convs):
            c = in_channels if i == 0 else feat_channels
            self.add_module(f"cls_conv_{i}", Conv2d(c, feat_channels, 3, 1, 1))
            self.add_module(f"reg_conv_{i}", Conv2d(c, feat_channels, 3, 1, 1))
        self.retina_cls = Conv2d(feat_channels, num_base_priors * num_classes,
                                 3, 1, 1)
        self.retina_reg = Conv2d(feat_channels, num_base_priors * box_version,
                                 3, 1, 1)
        # focal-loss prior: background logit bias so initial p ~ 0.01
        with torch.no_grad():
            self.retina_cls.bias.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(self, feats):
        """feats: tuple of (B, C, H, W) levels -> (cls_scores, bbox_preds),
        each a list of (B, H*W*A, num_classes | box_version) fp32 tensors."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            cls_feat, reg_feat = x, x
            for i in range(self.stacked_convs):
                cls_feat = F.relu(getattr(self, f"cls_conv_{i}")(cls_feat))
                reg_feat = F.relu(getattr(self, f"reg_conv_{i}")(reg_feat))
            b, _, h, w = x.shape
            n = h * w * self.num_base_priors
            cls_out = self.retina_cls(cls_feat).float().permute(0, 2, 3, 1)
            reg_out = self.retina_reg(reg_feat).float().permute(0, 2, 3, 1)
            cls_scores.append(cls_out.reshape(b, n, self.num_classes))
            bbox_preds.append(reg_out.reshape(b, n, self.box_version))
        return cls_scores, bbox_preds

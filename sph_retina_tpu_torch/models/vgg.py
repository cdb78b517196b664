"""SSD-VGG16 backbone + SSD neck (extra feature layers), NCHW.

VGG16's conv layers through conv5_3 with ceil-mode pooling, fc6/fc7 as a
dilated conv6 (3x3, dilation 6) and conv7 (1x1), outputs at conv4_3
(L2-normalised, learnable scale 20) and conv7; the neck appends four
two-conv extra blocks that each halve the resolution.

Sub-module names follow the variables of the JAX package's Flax modules
(``conv1_1`` ... ``conv5_3``, ``l2_norm``, ``conv6``, ``conv7``,
``extra_{i}_reduce``, ``extra_{i}_conv``), so that ``from_flax`` is a
mechanical rename; the L2Norm's Flax ``scale`` is its ``weight``.
``port_torchvision_vgg16`` maps torchvision's VGG16 ``features`` onto the
13 convs (``--load-backbone``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d, MaxPool2d, as_cpu_tensor

# VGG16: (conv count, channels) a block, a pool after each
VGG16_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# torchvision vgg16 ``features`` indices of the 13 conv layers
_TV_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation with a learnable per-channel scale,
    computed in fp32: x / (||x|| + 1e-10) * scale."""

    def __init__(self, channels: int, scale_init: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), scale_init))

    def forward(self, x):
        x32 = x.float()
        norm = torch.sqrt((x32 * x32).sum(dim=1, keepdim=True)) + 1e-10
        return (x32 / norm * self.weight.view(1, -1, 1, 1)).to(x.dtype)


class SSDVGG(nn.Module):
    """VGG16 trunk; returns (conv4_3 L2-normalised, conv7)."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for b, (n_convs, ch) in enumerate(VGG16_BLOCKS):
            for i in range(n_convs):
                self.add_module(f"conv{b + 1}_{i + 1}",
                                Conv2d(in_ch, ch, 3, 1, 1))
                in_ch = ch
            # 2x2 stride 2, the ragged edge padded on the bottom/right;
            # pool5: 3x3 stride 1 (the SSD variant keeps the resolution)
            self.add_module(f"pool{b + 1}",
                            MaxPool2d(2, 2, ceil_mode=True) if b < 4
                            else MaxPool2d(3, 1, 1))
        self.l2_norm = L2Norm(512)
        self.conv6 = Conv2d(512, 1024, 3, 1, padding=6, dilation=6)
        self.conv7 = Conv2d(1024, 1024, 1)

    def forward(self, x):
        feats = []
        for b, (n_convs, _) in enumerate(VGG16_BLOCKS):
            for i in range(n_convs):
                x = F.relu(getattr(self, f"conv{b + 1}_{i + 1}")(x))
            if b == 3:
                feats.append(self.l2_norm(x))  # conv4_3
            x = getattr(self, f"pool{b + 1}")(x)
        x = F.relu(self.conv6(x))
        x = F.relu(self.conv7(x))
        feats.append(x)
        return tuple(feats)


def port_torchvision_vgg16(state_dict: dict) -> dict:
    """torchvision VGG16 ``features.*`` conv weights -> the ``state_dict``
    entries of :class:`SSDVGG`'s 13 convs (``conv1_1`` ... ``conv5_3``).

    Only those transfer, as mmdet's SSDVGG loads them: ``conv6``, ``conv7``
    and the L2Norm scale keep their initialisation. Kernels stay OIHW.
    """
    out: dict = {}
    idx = iter(_TV_VGG16_CONV_IDX)
    for b, (n_convs, _) in enumerate(VGG16_BLOCKS):
        for i in range(n_convs):
            k = next(idx)
            for leaf in ("weight", "bias"):
                out[f"conv{b + 1}_{i + 1}.{leaf}"] = as_cpu_tensor(
                    state_dict[f"features.{k}.{leaf}"])
    return out


class SSDNeck(nn.Module):
    """Extra feature blocks: a 1x1 reduction to half the channels, then a
    3x3 stride-2 conv. Every extra halves, so each level sits on a
    power-of-2 stride (8..256), as the anchor grid assumes."""

    def __init__(self, out_channels: Sequence[int] = (512, 1024, 512, 256,
                                                      256, 256),
                 level_strides: Sequence[int] = (2, 2, 2, 2),
                 level_paddings: Sequence[int] = (1, 1, 1, 1)):
        super().__init__()
        self.n_extra = len(level_strides)
        in_ch = out_channels[1]
        for i, (ch, s, p) in enumerate(zip(out_channels[2:], level_strides,
                                           level_paddings)):
            self.add_module(f"extra_{i}_reduce", Conv2d(in_ch, ch // 2, 1))
            self.add_module(f"extra_{i}_conv", Conv2d(ch // 2, ch, 3, s, p))
            in_ch = ch

    def forward(self, feats):
        outs = list(feats)
        x = feats[-1]
        for i in range(self.n_extra):
            x = F.relu(getattr(self, f"extra_{i}_reduce")(x))
            x = F.relu(getattr(self, f"extra_{i}_conv")(x))
            outs.append(x)
        return tuple(outs)

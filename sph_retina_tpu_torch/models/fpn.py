"""Feature Pyramid Network neck.

mmdet-FPN semantics for the config the detectors use: ``start_level``,
``num_outs`` > inputs via stride-2 extra convs on the backbone's last input
(``add_extra_convs='on_input'``), nearest-neighbour top-down upsampling.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 start_level: int = 1, num_outs: int = 5):
        super().__init__()
        self.start_level = start_level
        used = list(in_channels[start_level:])
        for i, c in enumerate(used):
            self.add_module(f"lateral_{i}", Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_conv_{i}",
                            Conv2d(out_channels, out_channels, 3, 1, 1))
        self.num_extra = num_outs - len(used)
        for i in range(self.num_extra):
            self.add_module(f"extra_conv_{i}",
                            Conv2d(in_channels[-1] if i == 0 else out_channels,
                                   out_channels, 3, 2, 1))

    def forward(self, inputs):
        used = inputs[self.start_level:]
        laterals = [getattr(self, f"lateral_{i}")(x)
                    for i, x in enumerate(used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], scale_factor=2, mode="nearest")
        outs = [getattr(self, f"fpn_conv_{i}")(x)
                for i, x in enumerate(laterals)]
        extra_src = inputs[-1]
        for i in range(self.num_extra):
            extra_src = getattr(self, f"extra_conv_{i}")(extra_src)
            outs.append(extra_src)
        return tuple(outs)

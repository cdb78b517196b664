"""Feature Pyramid Network neck.

mmdet-FPN semantics for the configs the detectors use: ``start_level``,
``num_outs`` > inputs via stride-2 extra convs on the backbone's last input
(``add_extra_convs='on_input'``, the single-stage families) or on the last
output (``'on_output'``, Faster R-CNN), nearest-neighbour top-down
upsampling.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d


class FPN(nn.Module):
    # the width axis of a sharded model (parallel.sharding), for the upsample
    space = None

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 start_level: int = 1, num_outs: int = 5,
                 add_extra_convs: str = "on_input"):
        super().__init__()
        if add_extra_convs not in ("on_input", "on_output"):
            raise ValueError(f"add_extra_convs={add_extra_convs!r}")
        self.start_level = start_level
        self.extra_on_output = add_extra_convs == "on_output"
        used = list(in_channels[start_level:])
        for i, c in enumerate(used):
            self.add_module(f"lateral_{i}", Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_conv_{i}",
                            Conv2d(out_channels, out_channels, 3, 1, 1))
        self.num_extra = num_outs - len(used)
        first_in = out_channels if self.extra_on_output else in_channels[-1]
        for i in range(self.num_extra):
            self.add_module(f"extra_conv_{i}",
                            Conv2d(first_in if i == 0 else out_channels,
                                   out_channels, 3, 2, 1))

    def forward(self, inputs):
        used = inputs[self.start_level:]
        laterals = [getattr(self, f"lateral_{i}")(x)
                    for i, x in enumerate(used)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + (
                F.interpolate(laterals[i], scale_factor=2, mode="nearest")
                if self.space is None
                else self.space.upsample(self, i, laterals[i]))
        outs = [getattr(self, f"fpn_conv_{i}")(x)
                for i, x in enumerate(laterals)]
        extra_src = outs[-1] if self.extra_on_output else inputs[-1]
        for i in range(self.num_extra):
            extra_src = getattr(self, f"extra_conv_{i}")(extra_src)
            outs.append(extra_src)
        return tuple(outs)

"""ResNet backbone (torchvision-compatible topology).

Depth 18/34/50/101/152, multi-level outputs, batch norm that always runs on
its stored moments (``norm_eval`` semantics), 'pytorch'-style stride
placement (stride on the 3x3 conv of each bottleneck), ``groups`` /
``base_width`` for the ResNeXt variants.

Sub-module names follow the variables of the JAX package's Flax modules
(``layer1_0``, ``downsample_conv``, ``downsample_bn``), so that
``from_flax`` is a mechanical rename.

``remat=True`` checkpoints each residual block (the JAX package's
``nn.remat`` of each block): its activations are dropped after the forward
pass and recomputed in the backward one. Only a training forward with
gradients on checkpoints; eval, ``no_grad`` and ``torch.export`` run the
blocks as they are. The parameters and their names do not change.

Precision: parameters and BN moments stay fp32. A convolution casts its
weights to the dtype of its input at call time, and the batch norm folds
into one scale and one shift of that dtype; the network casts the image to
its working dtype (bf16 by default) once, on entry.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class Conv2d(nn.Conv2d):
    """Convolution with fp32 parameters that computes in its input's dtype.
    In a width-sharded model (``space``, set by
    ``parallel.sharding.partition_spatially``) it runs on this rank's
    columns through the axis's halo exchange."""

    space = None

    def forward(self, x):
        if self.space is not None:
            return self.space.window(self, x)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d``; in a width-sharded model (``space``, as
    :class:`Conv2d`) through the axis's halo exchange."""

    space = None

    def forward(self, x):
        if self.space is not None:
            return self.space.window(self, x)
        return super().forward(x)


@torch.no_grad()
def seeded_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation from an explicit generator, in parameter order:
    conv and dense kernels N(0, 1/fan_in), biases 0, every other parameter
    (norm scales, learned scalars) 1; batch-norm moments at identity. A
    model sets its own special values (a focal prior, an L2Norm scale)
    after."""
    for name, p in model.named_parameters():
        if p.ndim in (2, 4):
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(fan_in))
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    for name, b in model.named_buffers():
        b.fill_(1.0 if name.endswith("running_var") else 0.0)


class FrozenBatchNorm(nn.Module):
    """BatchNorm that always uses stored moments (norm_eval semantics)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * self.weight / torch.sqrt(
            self.running_var + self.eps)
        return x * inv.to(x.dtype).view(1, -1, 1, 1) \
            + shift.to(x.dtype).view(1, -1, 1, 1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        if downsample:
            self.downsample_conv = Conv2d(in_planes, planes, 1, stride,
                                          bias=False)
            self.downsample_bn = FrozenBatchNorm(planes)
        else:
            self.downsample_conv = None

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        # torchvision width rule: ResNeXt widens the inner convs
        # (e.g. groups=32, base_width=4 -> width = planes*2)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2d(in_planes, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        # 'pytorch' style: stride on the 3x3
        self.conv2 = Conv2d(width, width, 3, stride, 1, groups=groups,
                            bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = Conv2d(in_planes, planes * 4, 1, stride,
                                          bias=False)
            self.downsample_bn = FrozenBatchNorm(planes * 4)
        else:
            self.downsample_conv = None

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet / ResNeXt with multi-level outputs, NCHW in/out."""

    def __init__(self, depth: int = 50,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 groups: int = 1, base_width: int = 64,
                 remat: bool = False):
        super().__init__()
        block_kind, stage_blocks = ARCH_SETTINGS[depth]
        if block_kind != "bottleneck" and (groups != 1 or base_width != 64):
            raise ValueError("groups/base_width require a bottleneck depth "
                             "(>= 50)")
        self.out_indices = tuple(out_indices)
        self.stage_blocks = stage_blocks
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.maxpool = MaxPool2d(3, 2, 1)

        in_planes, planes = 64, 64
        self.out_channels = []
        for stage, n_blocks in enumerate(stage_blocks):
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                if block_kind == "bottleneck":
                    need_down = b == 0 and (stride != 1
                                            or in_planes != planes * 4)
                    block = Bottleneck(in_planes, planes,
                                       stride if b == 0 else 1, need_down,
                                       groups, base_width)
                else:
                    need_down = b == 0 and (stride != 1 or in_planes != planes)
                    block = BasicBlock(in_planes, planes,
                                       stride if b == 0 else 1, need_down)
                self.add_module(f"layer{stage + 1}_{b}", block)
                in_planes = planes * block.expansion
            self.out_channels.append(in_planes)
            planes *= 2

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        outs = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for stage, n_blocks in enumerate(self.stage_blocks):
            for b in range(n_blocks):
                block = getattr(self, f"layer{stage + 1}_{b}")
                x = checkpoint(block, x, use_reentrant=False) if remat \
                    else block(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)


def as_cpu_tensor(value) -> torch.Tensor:
    """A state-dict value (a tensor, or anything numpy takes) as a detached
    CPU tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


def port_torchvision_weights(state_dict: dict, depth: int = 50) -> dict:
    """A torchvision ResNet / ResNeXt ``state_dict`` (name -> tensor or
    array) -> the ``state_dict`` of :class:`ResNet` of that depth.

    ``layer1.0.conv2`` becomes ``layer1_0.conv2`` and ``layer1.0.downsample.
    0`` / ``.1`` become ``layer1_0.downsample_conv`` / ``downsample_bn``; a
    batch norm's ``weight``, ``bias``, ``running_mean`` and ``running_var``
    go into the :class:`FrozenBatchNorm` of the same name. Kernels stay
    OIHW, as in torchvision, grouped ones (ResNeXt) with I = in_channels /
    groups in both. ``num_batches_tracked`` and ``fc.*`` are not read.
    """
    kind, stage_blocks = ARCH_SETTINGS[depth]
    n_convs = 3 if kind == "bottleneck" else 2
    out: dict = {}

    def take(src: str, dst: str, leaves) -> None:
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = as_cpu_tensor(state_dict[f"{src}.{leaf}"])

    def conv(src: str, dst: str) -> None:
        take(src, dst, ("weight",))

    def bn(src: str, dst: str) -> None:
        take(src, dst, ("weight", "bias", "running_mean", "running_var"))

    conv("conv1", "conv1")
    bn("bn1", "bn1")
    for stage, n_blocks in enumerate(stage_blocks):
        for b in range(n_blocks):
            src, dst = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for i in range(1, n_convs + 1):
                conv(f"{src}.conv{i}", f"{dst}.conv{i}")
                bn(f"{src}.bn{i}", f"{dst}.bn{i}")
            if f"{src}.downsample.0.weight" in state_dict:
                conv(f"{src}.downsample.0", f"{dst}.downsample_conv")
                bn(f"{src}.downsample.1", f"{dst}.downsample_bn")
    return out

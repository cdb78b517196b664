"""Plain float32 networks of the two configurations: ResNet-50, the FPN, the
RetinaNet head and the FCOS head.

Written from the published descriptions (He et al. 2016, 'pytorch' style
bottlenecks with the stride on the 3x3 convolution; Lin et al. 2017, FPN
and RetinaNet; Tian et al. 2019, FCOS with GroupNorm towers, a learned
scale a level and exp-activated distances), in plain PyTorch and float32.
Batch norm runs on its stored moments, as detection backbones train it.
Parameter names follow the port's modules, so that the benchmark hands both
sides one set of weights by name. Nothing here imports the port.

``quant``: where given, ``quant(conv, x, weight)`` computes every
convolution. ``fp8`` computes it as float8 training does (e4m3 inputs and
weights with one scale a tensor, the product stored in bfloat16, e5m2
gradients): the lower-precision control that the check has to refuse.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the float8 ``dtype`` with one scale a tensor."""
    scale = (x.abs().amax().float() / top).clamp_min(1e-30)
    return (x / scale).to(dtype).float() * scale


class _Fp8Input(torch.autograd.Function):
    """Forward: round to e4m3. Backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Output(torch.autograd.Function):
    """Forward: round to bfloat16, as the program stores a product.
    Backward: the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(conv, x, w):
    """A convolution as float8 training computes it: e4m3 inputs and
    weights, the product stored in bfloat16, e5m2 gradients into the
    backward products."""
    return _Fp8Output.apply(conv(_Fp8Input.apply(x), _Fp8Input.apply(w)))


class Conv(nn.Conv2d):
    quant = None

    def forward(self, x):
        def conv(x, w):
            return F.conv2d(x, w, self.bias, self.stride, self.padding,
                            self.dilation, self.groups)

        if self.quant is not None:
            return self.quant(conv, x, self.weight)
        return conv(x, self.weight)


class FrozenBN(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, down: bool):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = Conv(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBN(planes * 4)
        self.down = down
        if down:
            self.downsample_conv = Conv(cin, planes * 4, 1, stride, bias=False)
            self.downsample_bn = FrozenBN(planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = self.downsample_bn(self.downsample_conv(x)) if self.down else x
        return F.relu(out + idt)


class ResNet50(nn.Module):
    BLOCKS = (3, 4, 6, 3)

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        cin, planes = 64, 64
        self.out_channels = []
        for stage, n in enumerate(self.BLOCKS):
            stride = 1 if stage == 0 else 2
            for b in range(n):
                self.add_module(f"layer{stage + 1}_{b}", Bottleneck(
                    cin, planes, stride if b == 0 else 1, b == 0))
                cin = planes * 4
            self.out_channels.append(cin)
            planes *= 2

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for stage, n in enumerate(self.BLOCKS):
            for b in range(n):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """From C3 (start level 1), five outputs; the two extra levels by
    stride-2 convolutions on C5 ('on_input'); nearest upsampling."""

    def __init__(self, in_channels, out: int = 256, num_outs: int = 5):
        super().__init__()
        used = list(in_channels[1:])
        for i, c in enumerate(used):
            self.add_module(f"lateral_{i}", Conv(c, out, 1))
            self.add_module(f"fpn_conv_{i}", Conv(out, out, 3, 1, 1))
        self.n_used = len(used)
        self.n_extra = num_outs - len(used)
        for i in range(self.n_extra):
            self.add_module(f"extra_conv_{i}", Conv(
                in_channels[-1] if i == 0 else out, out, 3, 2, 1))

    def forward(self, inputs):
        used = inputs[1:]
        lat = [getattr(self, f"lateral_{i}")(x) for i, x in enumerate(used)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], scale_factor=2,
                                                    mode="nearest")
        outs = [getattr(self, f"fpn_conv_{i}")(x) for i, x in enumerate(lat)]
        src = inputs[-1]
        for i in range(self.n_extra):
            src = getattr(self, f"extra_conv_{i}")(src)
            outs.append(src)
        return outs


def _flat(y, per_cell):
    """(B, A*C, H, W) -> (B, H*W*A, C)."""
    b, _, h, w = y.shape
    return y.permute(0, 2, 3, 1).reshape(b, h * w * (y.shape[1] // per_cell),
                                         per_cell)


class RetinaHead(nn.Module):
    def __init__(self, num_classes: int, box_version: int, anchors: int = 9,
                 ch: int = 256, convs: int = 4):
        super().__init__()
        self.c, self.d, self.convs = num_classes, box_version, convs
        for i in range(convs):
            self.add_module(f"cls_conv_{i}", Conv(ch, ch, 3, 1, 1))
            self.add_module(f"reg_conv_{i}", Conv(ch, ch, 3, 1, 1))
        self.retina_cls = Conv(ch, anchors * num_classes, 3, 1, 1)
        self.retina_reg = Conv(ch, anchors * box_version, 3, 1, 1)

    def forward(self, feats):
        cls, reg = [], []
        for x in feats:
            c, r = x, x
            for i in range(self.convs):
                c = F.relu(getattr(self, f"cls_conv_{i}")(c))
                r = F.relu(getattr(self, f"reg_conv_{i}")(r))
            cls.append(_flat(self.retina_cls(c), self.c))
            reg.append(_flat(self.retina_reg(r), self.d))
        return cls, reg


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(()))


class FCOSHead(nn.Module):
    GN_EPS = 1e-6

    def __init__(self, num_classes: int, box_version: int, ch: int = 256,
                 convs: int = 4, levels: int = 5):
        super().__init__()
        self.c, self.d, self.convs = num_classes, box_version, convs
        for tower in ("cls", "reg"):
            for i in range(convs):
                self.add_module(f"{tower}_conv_{i}",
                                Conv(ch, ch, 3, 1, 1, bias=False))
                self.add_module(f"{tower}_gn_{i}",
                                nn.GroupNorm(32, ch, eps=self.GN_EPS))
        self.conv_cls = Conv(ch, num_classes, 3, 1, 1)
        self.conv_reg = Conv(ch, box_version, 3, 1, 1)
        self.conv_centerness = Conv(ch, 1, 3, 1, 1)
        for i in range(levels):
            self.add_module(f"scale_{i}", Scale())

    def _tower(self, name, x):
        for i in range(self.convs):
            x = F.relu(getattr(self, f"{name}_gn_{i}")(
                getattr(self, f"{name}_conv_{i}")(x)))
        return x

    def forward(self, feats):
        cls, reg, ctr = [], [], []
        for lvl, x in enumerate(feats):
            c, r = self._tower("cls", x), self._tower("reg", x)
            scale = getattr(self, f"scale_{lvl}").weight
            cls.append(_flat(self.conv_cls(c), self.c))
            reg.append(_flat(torch.exp(self.conv_reg(r) * scale), self.d))
            ctr.append(_flat(self.conv_centerness(r), 1)[..., 0])
        return cls, reg, ctr


IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalise(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32, ImageNet mean and std."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    return ((images_u8.float() - mean) / std).permute(0, 3, 1, 2).contiguous()


class Detector(nn.Module):
    """ResNet-50 + FPN + the family's head; ``forward`` takes uint8 images
    (B, H, W, 3) and returns the head's per-level outputs."""

    def __init__(self, family: str, num_classes: int, box_version: int):
        super().__init__()
        self.family = family
        self.backbone = ResNet50()
        self.neck = FPN(self.backbone.out_channels)
        self.bbox_head = (RetinaHead(num_classes, box_version)
                          if family == "retinanet"
                          else FCOSHead(num_classes, box_version))

    def set_quant(self, quant) -> None:
        for m in self.modules():
            if isinstance(m, Conv):
                m.quant = quant

    def forward(self, images_u8):
        return self.bbox_head(self.neck(self.backbone(normalise(images_u8))))


def focal_bias() -> float:
    """The classifier's prior bias: initial foreground probability 0.01."""
    return -math.log((1 - 0.01) / 0.01)

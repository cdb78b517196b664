"""Frozen FLOP counter: the products (convolutions and dense products) a
model computes, counted by their shapes.

A copy of the port's ``get_flops.py:OpCounter`` rules for products: a
convolution counts 2 FLOPs a multiply-add over the taps that fall inside its
input (padding taps left out); ``convolution_backward`` counts each gradient
it computes (input, weight) as one such convolution; a dense product 2 a
multiply-add. It is applied to the benchmark's own plain reference on
``meta`` tensors, so the count is the same whatever implements the model
and costs no device time. Pointwise work is not counted: the utilisation
metrics are of the tensor cores' work.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


@functools.lru_cache(maxsize=None)
def _in_bounds_taps(size, k, stride, pad, dilation) -> int:
    out = (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    return sum(1 for o in range(out) for t in range(k)
               if 0 <= o * stride - pad + t * dilation < size)


def conv_macs(x_shape, w_shape, stride, padding, dilation, groups) -> int:
    """Multiply-adds of a convolution over its in-bounds taps."""
    n, c_in = x_shape[:2]
    taps = math.prod(_in_bounds_taps(int(s), int(k), int(st), int(p), int(d))
                     for s, k, st, p, d in zip(x_shape[2:], w_shape[2:],
                                               stride, padding, dilation))
    return n * w_shape[0] * (c_in // groups) * taps


class ProductCounter(TorchDispatchMode):
    """Sums the FLOPs of the products run under it into ``flops``."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet is aten.convolution:
            x, w, _, stride, padding, dilation, transposed, _, groups = args[:9]
            if transposed:
                raise ValueError("a transposed convolution is not counted")
            self.flops += 2 * conv_macs(x.shape, w.shape, stride, padding,
                                        dilation, groups)
        elif packet is aten.convolution_backward:
            (_, x, w, _, stride, padding, dilation, _, _, groups,
             mask) = args[:11]
            self.flops += 2 * conv_macs(x.shape, w.shape, stride, padding,
                                        dilation, groups) * (int(mask[0])
                                                             + int(mask[1]))
        elif packet in (aten.mm, aten.bmm):
            a, b = args[:2]
            self.flops += 2 * a.numel() * b.shape[-1]
        elif packet is aten.addmm:
            a, b = args[1:3]
            self.flops += 2 * a.numel() * b.shape[-1]
        return out


def count_products(fn, *args) -> int:
    """FLOPs of the products of ``fn(*args)``."""
    with ProductCounter() as counter:
        fn(*args)
    return counter.flops


def model_flops(config: dict, batch: int, backward: bool) -> int:
    """Products of the reference network's forward (and, with
    ``backward``, of its backward, frozen stages computing no weight
    gradient) on ``batch`` images of the configuration's size, on ``meta``
    tensors."""
    from .reference.detector import trainable
    from .reference.nets import Detector

    with torch.device("meta"):
        model = Detector(config["family"], config["num_classes"],
                         config["box_version"])
        images = torch.empty((batch, *config["img_size"], 3),
                             dtype=torch.uint8)
    for name, p in model.named_parameters():
        p.requires_grad_(backward and trainable(config, name))

    def step():
        outs = model(images)
        if backward:
            sum(t.sum() for level in outs for t in level).backward()

    with torch.set_grad_enabled(backward):
        return count_products(step)

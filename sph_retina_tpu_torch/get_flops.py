"""FLOPs and parameters of a configured detector's forward pass.

    python -m sph_retina_tpu_torch.get_flops CONFIG [--shape H W] \\
        [--batch N] [--device cuda|cpu] [--cfg-options k=v ...]

The forward runs once, eagerly, under ``OpCounter``, a dispatch mode that
sees every aten operation and counts it by its shapes only (so the count on
the card equals the count on the CPU):

- a convolution counts 2 FLOPs a multiply-add over the taps that fall
  inside its input, padding taps left out, as XLA's cost analysis counts
  them; a dense product (``mm``, ``addmm``, ``bmm``) 2 a multiply-add;
  ``convolution_backward`` counts each gradient it computes (input,
  weight) as one such convolution;
- a pointwise operation 1 a result element (a convolution's bias add too),
  a reduction 1 an input element, a max pool ``window - 1`` an output
  element; a copy or a type conversion none (a copy's presence depends on
  memory layouts, which differ between devices, and the FLOPs must not);
- bytes: every tensor read and written by each operation that is not a
  view, once an operation — the traffic of the eager program, not of a
  fused one.

Where the detector has a ``bbox_head`` (RetinaNet, FCOS, SSD), the head's
FLOPs are counted apart too, on the inputs the forward gave it: the share a
split over "space" divides (``parallel/sharding.py``).

The JAX tool reads XLA's cost analysis of the compiled forward. The two
counts differ where XLA's does: it counts a type conversion as 1 FLOP an
element and, on the CPU, each bf16 operation as an f32 one between two
conversions; the port counts neither.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import math
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .engine.zoo import get_family
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device

aten = torch.ops.aten


def _fmt(n: float, unit: str) -> str:
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if n >= scale:
            return f"{n / scale:.2f} {suffix}{unit}"
    return f"{n:.0f} {unit}"


def _in_bounds_taps(size: int, k: int, stride: int, pad: int,
                    dilation: int) -> int:
    """(output position, kernel tap) pairs of one spatial axis whose input
    index lies inside ``[0, size)``."""
    out = (size + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    return sum(1 for o in range(out) for t in range(k)
               if 0 <= o * stride - pad + t * dilation < size)


def conv_macs(x_shape, w_shape, stride, padding, dilation,
              transposed: bool, groups: int) -> int:
    """Multiply-adds of a convolution over its in-bounds taps: batch x
    output channels x input channels per group x, per spatial axis, the
    in-bounds (output, tap) pairs."""
    if transposed:
        raise ValueError("a transposed convolution is not counted")
    n, c_in = x_shape[:2]
    c_out = w_shape[0]
    taps = math.prod(
        _in_bounds_taps(size, k, s, p, d) for size, k, s, p, d in zip(
            x_shape[2:], w_shape[2:], stride, padding, dilation))
    return n * c_out * (c_in // groups) * taps


def _conv(args, out):
    x, w, bias, stride, padding, dilation, transposed, _, groups = args[:9]
    flops = {"convolution": 2 * conv_macs(x.shape, w.shape, stride, padding,
                                          dilation, transposed, groups)}
    if bias is not None:
        flops["elementwise"] = out.numel()
    return flops


def _conv_backward(args, out):
    (grad_out, x, w, bias_sizes, stride, padding, dilation, transposed, _,
     groups, mask) = args[:11]
    macs = conv_macs(x.shape, w.shape, stride, padding, dilation,
                     transposed, groups)
    flops = {"convolution": 2 * macs * (int(mask[0]) + int(mask[1]))}
    if mask[2]:
        flops["elementwise"] = grad_out.numel()
    return flops


def _mm(args, out):
    a, b = args[-2:] if len(args) == 3 else args[:2]  # addmm(bias, a, b)
    flops = {"matmul": 2 * a.numel() * b.shape[-1]}
    if len(args) == 3:
        flops["elementwise"] = out.numel()
    return flops


def _bmm(args, out):
    a, b = args[:2]
    return {"matmul": 2 * a.numel() * b.shape[-1]}


def _max_pool(args, out):
    kernel = args[1]
    window = math.prod(kernel) if len(kernel) > 1 else kernel[0] ** 2
    first = out[0] if isinstance(out, tuple) else out
    return {"elementwise": first.numel() * (window - 1)}


_FORMULAS = {
    aten.convolution: _conv,
    aten.convolution_backward: _conv_backward,
    aten.mm: _mm,
    aten.addmm: _mm,
    aten.bmm: _bmm,
    aten.max_pool2d_with_indices: _max_pool,
}


@dataclasses.dataclass
class Count:
    """FLOPs by class (``convolution``, ``matmul``, ``elementwise``) and
    bytes moved."""

    flops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: int = 0

    @property
    def products(self) -> int:
        """Convolutions and dense products: the work of the tensor cores."""
        return self.flops["convolution"] + self.flops["matmul"]

    @property
    def total(self) -> int:
        return sum(self.flops.values())


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten operation run under it (see
    the module's docstring for the rules)."""

    def __init__(self):
        super().__init__()
        self.count = Count()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet in _FORMULAS:
            self.count.flops.update(_FORMULAS[packet](args, out))
        elif torch.Tag.pointwise in func.tags and packet is not aten.clone:
            first = out[0] if isinstance(out, (tuple, list)) else out
            self.count.flops["elementwise"] += first.numel()
        elif torch.Tag.reduction in func.tags:
            self.count.flops["elementwise"] += args[0].numel()
        if not func.is_view:
            self.count.bytes += sum(
                t.nbytes for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def count_flops(fn, *args) -> Count:
    """``fn(*args)`` run once under ``OpCounter``: its FLOPs by class and its
    bytes."""
    with OpCounter() as counter:
        fn(*args)
    return counter.count


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config")
    p.add_argument("--shape", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="input size (default: cfg img_size)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    if args.shape:
        cfg["img_size"] = tuple(args.shape)
    h, w = cfg.get("img_size", (512, 1024))

    model, _ = get_family(cfg).build(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    images = torch.zeros((args.batch, h, w, 3), device=device)
    head = getattr(model, "bbox_head", None)
    feats = []
    if head is not None:
        head.register_forward_pre_hook(lambda m, a: feats.append(a))
    with torch.no_grad():
        count = count_flops(model, images)
        head_count = count_flops(head, *feats[0]) if feats else None

    print(f"config:     {os.path.basename(args.config)}")
    print(f"input:      ({args.batch}, {h}, {w}, 3)")
    print(f"params:     {_fmt(n_params, '')} ({n_params})")
    print(f"flops:      {_fmt(count.total, 'FLOPs')} (eager aten ops, fwd: "
          f"in-bounds conv taps, 2 a MAC; 1 a pointwise element)")
    print(f"hbm bytes:  {_fmt(count.bytes, 'B')} (each eager op's inputs "
          f"and outputs once)")
    if head_count is not None:
        print(f"head:       {_fmt(head_count.total, 'FLOPs')} "
              f"({100 * head_count.total / count.total:.1f} % of the forward)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

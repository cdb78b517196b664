"""IoU benchmark and consistency harness.

    python -m sph_retina_tpu_torch.benchmark_iou --size 1000000 --kernel
    python -m sph_retina_tpu_torch.benchmark_iou --size 100000 \
        --backends sph2pob_efficient sph2pob_standard sph fov unbiased

Draws ``--size`` seeded random pairs of spherical boxes and reports, one JSON
line a row, the time of N matched pairs and the largest difference from the
plain fused pipeline:

- ``fused_plain``   the plain PyTorch version (``ops/fused_iou.py``);
- ``kernel_fused``  with ``--kernel``: the hand-written CUDA kernel
  (``ops.sph2pob_iou_aligned``; needs the CUDA device);
- one row a backend named by ``--backends``: ``sph_overlaps(...,
  is_aligned=True)``, plain PyTorch, for any of ``sph2pob_efficient``,
  ``sph2pob_standard``, ``sph2pob_legacy``, ``sph``, ``fov``, ``naive``,
  ``kent`` and ``unbiased``.

With ``--backends``, every row also has its error against the ``unbiased``
oracle: ``mean_err``, ``median_err``, ``max_err`` (absolute) and
``pearson_r``, as the JAX package's tool reports them. On the card a row's
time is taken by CUDA events around ``--iters`` calls after one warm-up
call; on the CPU by the host's clock.

Runs on the CUDA device unless ``--device cpu`` is given; without a card it
raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .geometry import generate_boxes
from .iou.api import (
    AVAILABLE_BACKENDS,
    BACKENDS,
    canonical_backend,
    sph_overlaps,
)
from .ops import sph2pob_iou_aligned, sph2pob_iou_aligned_plain
from .utils.device import resolve_device


def _timed(fn, b1, b2, iters: int, device: torch.device):
    """(result of one call, seconds a call over ``iters`` calls)."""
    out = fn(b1, b2)  # warm-up: builds the kernel on first use
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn(b1, b2)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(b1, b2)
    return out, (time.perf_counter() - t0) / iters


def _errors(values: torch.Tensor, gold: np.ndarray) -> dict:
    """Absolute error against the unbiased oracle, and Pearson's r."""
    values = values.double().cpu().numpy()
    err = np.abs(values - gold)
    return dict(mean_err=float(err.mean()), median_err=float(np.median(err)),
                max_err=float(err.max()),
                pearson_r=float(np.corrcoef(values, gold)[0, 1]))


def run(size: int, box_version: int = 4, iters: int = 10, seed: int = 0,
        device=None, kernel: bool = False, backends=()) -> list[dict]:
    """The rows of the table, as dictionaries."""
    backends = [canonical_backend(name) for name in backends]
    for backend in backends:
        if backend not in BACKENDS:
            raise ValueError(f"unknown IoU backend {backend!r}; "
                             f"choose from {BACKENDS}")
    if size < 1 or iters < 1:
        raise ValueError("--size and --iters must be at least 1")
    device = resolve_device(device)
    if kernel and device.type != "cuda":
        raise ValueError("--kernel times the CUDA kernel and needs the CUDA "
                         "device; on the CPU only fused_plain is reported")

    b1 = torch.from_numpy(generate_boxes(size, box_version, seed=seed)).to(device)
    b2 = torch.from_numpy(
        generate_boxes(size, box_version, seed=seed + 1)).to(device)

    rows = []
    with torch.no_grad():
        plain, t = _timed(sph2pob_iou_aligned_plain, b1, b2, iters, device)
        rows.append(dict(backend="fused_plain", time_s=t,
                         mpairs_per_s=size / t / 1e6, max_abs_diff=0.0))
        if kernel:
            got, t = _timed(sph2pob_iou_aligned, b1, b2, iters, device)
            rows.append(dict(
                backend="kernel_fused", time_s=t, mpairs_per_s=size / t / 1e6,
                max_abs_diff=float((got - plain).abs().max())))
        if backends:
            outputs = {"fused_plain": plain}
            if kernel:
                outputs["kernel_fused"] = got
            for backend in backends:
                out, t = _timed(
                    lambda a, b, bk=backend: sph_overlaps(a, b, bk, True),
                    b1, b2, iters, device)
                outputs[backend] = out
                rows.append(dict(
                    backend=backend, time_s=t, mpairs_per_s=size / t / 1e6,
                    max_abs_diff=float((out - plain).abs().max())))
            gold = (outputs["unbiased"] if "unbiased" in outputs
                    else sph_overlaps(b1, b2, "unbiased", True))
            gold = gold.double().cpu().numpy()
            for row in rows:
                row.update(_errors(outputs[row["backend"]], gold))
    for row in rows:
        row.update(size=size, box_version=box_version, iters=iters,
                   device=(torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=1_000_000)
    p.add_argument("--box-version", type=int, default=4, choices=[4, 5])
    p.add_argument("--backends", nargs="*", default=[],
                   help="further IoU backends by name, each a row with its "
                        "error against the unbiased oracle: "
                        + " ".join(AVAILABLE_BACKENDS))
    p.add_argument("--kernel", action="store_true",
                   help="also time the fused CUDA kernel")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    rows = run(args.size, args.box_version, args.iters, args.seed,
               args.device, args.kernel, args.backends)
    print(f"# {args.size:,} random pairs, box_version={args.box_version}, "
          f"device={rows[0]['device']}")
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())

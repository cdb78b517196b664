"""Inference images a second of a configured detector.

    python -m sph_retina_tpu_torch.benchmark_fps CONFIG [--batch-size N] \\
        [--max-iter 200] [--warmup 5] [--with-nms] [--device cuda|cpu] \\
        [--cfg-options k=v ...]

The config's detector family (``engine/zoo.py:get_family``: RetinaNet,
FCOS, SSD or Faster R-CNN), randomly initialised weights (seed 0) and
``torch.randn`` images from a seeded generator on the device. Without
``--with-nms`` one call is the network's forward; with it, the family's
predict (``family.predict_fn``: top-k, decode and the NMS; where the NMS
backend is ``sph2pob_efficient`` its IoU matrix is one launch of the
pairwise kernel an image whatever the scores). ``--warmup`` calls, then
``--max-iter`` calls ended by one synchronisation; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .engine.zoo import get_family
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device, synchronize


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--max-iter", type=int, default=200)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--with-nms", action="store_true",
                   help="include decode+NMS postprocessing")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    h, w = cfg.get("img_size", (512, 1024))
    b = args.batch_size
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn((b, h, w, 3), device=device, generator=gen)

    if args.with_nms:
        predict = family.predict_fn(model, det_cfg)
        run = lambda: predict(images)  # noqa: E731
    else:
        def run():
            with torch.no_grad():
                return model(images)

    for _ in range(args.warmup):
        run()
        synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.max_iter):
        run()
    synchronize(device)
    dt = (time.perf_counter() - t0) / args.max_iter
    print(json.dumps({
        "img_per_s": round(b / dt, 2),
        "ms_per_batch": round(dt * 1e3, 2),
        "batch_size": b,
        "img_size": [h, w],
        "with_nms": bool(args.with_nms),
        "device": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

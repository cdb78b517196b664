"""Export a detector's predict path as one ``torch.export`` artifact.

    python -m sph_retina_tpu_torch.export_model CONFIG CKPT|none OUT \
        [--batch-size N] [--device cpu] [--run IMAGE] [--cfg-options ...]

The twin of the JAX package's ``tools/export_model.py``: one file holding
backbone, FPN, head, decode and NMS with the weights in it
(``export.export_predict``). ``CKPT`` is what ``init_detector`` takes — a
published ``.npz``, a checkpoint directory of the trainer or one
``epoch_N`` file — or ``none`` for the random initialisation of seed 0. The
artifact takes float32 ``(N, H, W, 3)`` normalised images at the config's
``img_size`` and runs on the device it was exported on: the CUDA device
unless ``--device cpu`` is given. ``--run IMAGE`` loads the artifact back
and runs it on that image (repeated to the batch size), printing the
detection count of image 0.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .apis import _prepare, init_detector
from .data.pipeline import maybe_normalize_images
from .export import export_predict, load_exported
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Export a detector's predict path as one artifact")
    p.add_argument("config")
    p.add_argument("checkpoint",
                   help="published .npz, checkpoint directory or epoch_N "
                        "file of the trainer, or 'none'")
    p.add_argument("out", help="output artifact path")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="the device the artifact runs on (default: the "
                        "CUDA device)")
    p.add_argument("--run", default=None, metavar="IMAGE",
                   help="run the artifact on this image and print the "
                        "detection count of image 0")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    ckpt = None if args.checkpoint.lower() == "none" else args.checkpoint
    det = init_detector(args.config, ckpt, cfg_options=args.cfg_options,
                        device=device)
    blob = export_predict(det, batch_size=args.batch_size)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported {len(blob) / 1e6:.1f} MB -> {args.out}")

    if args.run:
        call = load_exported(blob)
        img = torch.from_numpy(np.ascontiguousarray(_prepare(det, args.run)))
        batch = img[None].expand(args.batch_size, -1, -1, -1).to(device)
        _, _, _, _, valid = call(maybe_normalize_images(batch))
        print(f"artifact ran: {int(valid[0].sum())} detections in image 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())

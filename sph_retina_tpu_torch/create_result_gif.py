"""Assemble an animated GIF from the galleries of ``analyze_results``.

    python -m sph_retina_tpu_torch.create_result_gif OUT_DIR --out result.gif

Pages through the PNG / JPEG images under ``OUT_DIR`` (recursively, each
folder's files in name order), resized to the smallest height and width
among them, ``--ncols`` side by side a frame (the last frame padded with
black), ``--duration`` seconds a frame, looping. Written by PIL's GIF
writer. Host only.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Create GIF from result images")
    p.add_argument("image_dir",
                   help="directory written by analyze_results (searched "
                        "recursively for png/jpg)")
    p.add_argument("--out", default="result.gif")
    p.add_argument("--duration", type=float, default=2.0,
                   help="seconds per frame")
    p.add_argument("--ncols", type=int, default=1,
                   help="tile this many images per frame")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from PIL import Image

    args = parse_args(argv)
    paths = []
    for root, _, files in os.walk(args.image_dir):
        for f in sorted(files):
            if f.lower().endswith((".png", ".jpg", ".jpeg")):
                paths.append(os.path.join(root, f))
    if not paths:
        raise SystemExit(f"no images under {args.image_dir}")

    imgs = []
    for path in paths:
        with Image.open(path) as im:
            imgs.append(np.asarray(im.convert("RGB")))
    h = min(im.shape[0] for im in imgs)
    w = min(im.shape[1] for im in imgs)
    imgs = [np.asarray(Image.fromarray(im).resize((w, h))) for im in imgs]

    frames = []
    for i in range(0, len(imgs), args.ncols):
        tile = imgs[i:i + args.ncols]
        while len(tile) < args.ncols:  # pad the last frame row
            tile.append(np.zeros_like(tile[0]))
        frames.append(Image.fromarray(np.concatenate(tile, axis=1)))
    frames[0].save(args.out, format="GIF", save_all=True,
                   append_images=frames[1:],
                   duration=int(round(args.duration * 1000.0)), loop=0)
    print(f"{len(frames)} frames -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

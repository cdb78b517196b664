"""Render dataset images with their ground-truth spherical boxes drawn.

    python -m sph_retina_tpu_torch.browse_dataset CONFIG --out-dir browsed \\
        --max-images 20
    python -m sph_retina_tpu_torch.browse_dataset CONFIG --split val \\
        --no-pipeline

Walks the config's ``data.<split>`` through the pipeline (the training one,
flips drawn from ``--seed``, for ``train``) and writes each image with its
boxes rasterised (great-circle borders, ``visualize/sph_draw.py``) as
``<out-dir>/<image name>.png``, so that annotations and augmentations can be
eyeballed. The pipeline's normalised image is mapped back to pixels;
``--no-pipeline`` draws on the decoded image instead. Host only.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .data import SphCocoDataset, SphPipeline
from .utils.config import load_config
from .visualize import draw_boxes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Draw a dataset's ground truth")
    p.add_argument("config")
    p.add_argument("--split", default="train",
                   choices=["train", "val", "test"])
    p.add_argument("--out-dir", default="browsed_dataset")
    p.add_argument("--max-images", type=int, default=50)
    p.add_argument("--no-pipeline", action="store_true",
                   help="draw on the raw image instead of the piped one")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from PIL import Image

    args = parse_args(argv)
    cfg = load_config(args.config)
    d = cfg["data"][args.split]
    box_version = cfg["model"].get("box_version", 4)
    ds = SphCocoDataset(ann_file=d["ann_file"],
                        img_prefix=d.get("img_prefix", ""),
                        box_version=box_version)
    training = args.split == "train"
    pipe = SphPipeline(
        img_size=tuple(cfg.get("img_size", (512, 1024))),
        flip_ratio=cfg["data"].get("flip_ratio", 0.5) if training else 0.0,
        max_gt=cfg["data"].get("max_gt", 64),
        box_version=box_version,
        training=training,
        native_decoder=cfg["data"].get("native_decoder", True),
    )
    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    names = ds.classes or None

    n = min(len(ds), args.max_images)
    for i in range(n):
        item = ds[i]
        if args.no_pipeline:
            img = pipe.load_image(item["img_path"]).astype(np.uint8)
            boxes, labels = item["boxes"], item["labels"]
        else:
            out = pipe(item, rng)
            img = np.clip(out["images"] * pipe.std + pipe.mean, 0, 255)
            m = out["gt_mask"].astype(bool)
            boxes, labels = out["gt_boxes"][m], out["gt_labels"][m]
        vis = draw_boxes(img, boxes, labels=labels, class_names=names)
        name = os.path.splitext(os.path.basename(item["file_name"]))[0]
        Image.fromarray(vis).save(os.path.join(args.out_dir, f"{name}.png"))
    print(f"wrote {n} images to {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())

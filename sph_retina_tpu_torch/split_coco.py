"""K-fold labeled / unlabeled splits of a COCO-style annotation file.

    python -m sph_retina_tpu_torch.split_coco ANN.json OUT_DIR \\
        [--labeled-percent 1 2 5 10] [--fold 5] [--seed 1]

For each fold and labeled percent, writes
``instances_train.{fold}@{pct}.json`` (a random share of the images with
their annotations) and ``instances_train.{fold}@{pct}-unlabeled.json`` (the
other images, no annotations). Fold ``f`` permutes the images with
``np.random.default_rng(seed + f)``, as the JAX package's tool does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def split(ann_file: str, out_dir: str, percents, folds: int, seed: int = 1):
    with open(ann_file) as f:
        coco = json.load(f)
    images = coco.get("images", [])
    anns_by_img: dict = {}
    for a in coco.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fold in range(1, folds + 1):
        rng = np.random.default_rng(seed + fold)
        order = rng.permutation(len(images))
        for pct in percents:
            n_lab = int(round(len(images) * pct / 100.0))
            lab_idx = set(order[:n_lab].tolist())
            for name, keep in (("labeled", True), ("unlabeled", False)):
                imgs = [im for i, im in enumerate(images)
                        if (i in lab_idx) == keep]
                ids = {im["id"] for im in imgs}
                sub = {
                    "images": imgs,
                    "annotations": [a for im_id, anns in anns_by_img.items()
                                    if im_id in ids for a in anns]
                    if keep else [],
                    "categories": coco.get("categories", []),
                }
                path = os.path.join(
                    out_dir, f"instances_train.{fold}@{pct:g}"
                    + ("" if keep else "-unlabeled") + ".json")
                with open(path, "w") as f:
                    json.dump(sub, f)
                written.append(path)
    return written


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("ann_file")
    p.add_argument("out_dir")
    p.add_argument("--labeled-percent", nargs="+", type=float,
                   default=[1, 2, 5, 10])
    p.add_argument("--fold", type=int, default=5)
    p.add_argument("--seed", type=int, default=1)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for path in split(args.ann_file, args.out_dir, args.labeled_percent,
                      args.fold, args.seed):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

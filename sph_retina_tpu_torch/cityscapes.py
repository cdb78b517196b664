"""Convert Cityscapes gtFine instance annotations to spherical COCO JSON.

    python -m sph_retina_tpu_torch.cityscapes gtFine/train out.json \\
        [--img-dir leftImg8bit/train]

Decodes the ``*_gtFine_instanceIds.png`` maps directly: pixels >= 24 carry
instance-capable labels, ids >= 1000 encode ``label_id * 1000 + instance``
and ids < 1000 are crowd regions. Each instance's pixel bounding box is
reinterpreted on the image's ERP chart as a BFoV in degrees
(``chart_util.pix2bfov``, as ``pascal_voc.py``). Host code: numpy and PIL.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from .chart_util import pix2bfov

# The 8 instance-having Cityscapes classes (hasInstances=True), id -> name,
# in the category order of the reference's converter.
CITYSCAPES_INSTANCE_LABELS = {
    24: "person", 25: "rider", 26: "car", 27: "truck",
    28: "bus", 31: "train", 32: "motorcycle", 33: "bicycle",
}
CITYSCAPES_CLASSES = tuple(CITYSCAPES_INSTANCE_LABELS.values())

GT_SUFFIX = "gtFine_instanceIds.png"
IMG_SUFFIX = "leftImg8bit.png"


def _connected_components(mask):
    """4-connected component masks of a boolean image (a breadth-first
    growth: crowd regions are rare enough that this never dominates)."""
    remaining = mask.copy()
    comps = []
    while remaining.any():
        ys, xs = np.nonzero(remaining)
        comp = np.zeros_like(mask)
        comp[ys[0], xs[0]] = True
        while True:
            # dilate by one 4-neighborhood step, clipped to the mask
            grown = comp.copy()
            grown[1:, :] |= comp[:-1, :]
            grown[:-1, :] |= comp[1:, :]
            grown[:, 1:] |= comp[:, :-1]
            grown[:, :-1] |= comp[:, 1:]
            grown &= remaining
            if (grown == comp).all():
                break
            comp = grown
        comps.append(comp)
        remaining &= ~comp
    return comps


def instances_from_idmap(inst_img):
    """(label_id, iscrowd, x1, y1, x2, y2, area) per instance of an
    instance-id map.

    Crowd pixels (id < 1000) share one id a label, unlike real instances;
    one box over all of them would span unrelated regions (two groups of
    people at opposite edges), so crowd ids are split into connected
    components first, one record each, as the reference's polygons are."""
    out = []
    for inst_id in np.unique(inst_img[inst_img >= 24]):
        inst_id = int(inst_id)
        label_id = inst_id // 1000 if inst_id >= 1000 else inst_id
        if label_id not in CITYSCAPES_INSTANCE_LABELS:
            continue
        mask = inst_img == inst_id
        iscrowd = int(inst_id < 1000)
        regions = _connected_components(mask) if iscrowd else [mask]
        for region in regions:
            ys, xs = np.nonzero(region)
            out.append((label_id, iscrowd,
                        int(xs.min()), int(ys.min()),
                        int(xs.max()) + 1, int(ys.max()) + 1, int(len(xs))))
    return out


def convert(gt_dir: str, out_file: str, img_dir: str = "") -> dict:
    """``img_dir``, when given, is only used to warn about missing images;
    file_name entries stay relative (the loader's img_prefix supplies the
    leftImg8bit root)."""
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(gt_dir, "**", "*" + GT_SUFFIX),
                             recursive=True))
    if not paths:
        raise SystemExit(f"no *_{GT_SUFFIX} under {gt_dir}")
    cat_of = {lid: i + 1
              for i, lid in enumerate(CITYSCAPES_INSTANCE_LABELS)}
    images, annotations = [], []
    ann_id = 1
    for img_id, path in enumerate(paths, start=1):
        rel = os.path.relpath(path, gt_dir)
        file_name = rel[: -len(GT_SUFFIX)] + IMG_SUFFIX
        if img_dir and not os.path.exists(os.path.join(img_dir, file_name)):
            print(f"warning: no image {file_name} under {img_dir}")
        inst_img = np.asarray(Image.open(path))
        h, w = inst_img.shape[:2]
        images.append({"id": img_id, "file_name": file_name,
                       "width": w, "height": h})
        for label_id, iscrowd, x1, y1, x2, y2, area in \
                instances_from_idmap(inst_img):
            annotations.append({
                "id": ann_id, "image_id": img_id,
                "category_id": cat_of[label_id],
                "bbox": pix2bfov(x1, y1, x2, y2, w, h),
                "iscrowd": iscrowd, "area": area,
            })
            ann_id += 1
    out = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(CITYSCAPES_CLASSES)],
    }
    with open(out_file, "w") as f:
        json.dump(out, f)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("gt_dir", help="gtFine split dir (city subdirs inside)")
    p.add_argument("out_file", help="output COCO JSON")
    p.add_argument("--img-dir", default="",
                   help="leftImg8bit split dir, only to warn about missing "
                        "images (file_name entries stay relative)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = convert(args.gt_dir, args.out_file, args.img_dir)
    n_crowd = sum(a["iscrowd"] for a in out["annotations"])
    print(f"{len(out['images'])} images, {len(out['annotations'])} "
          f"annotations ({n_crowd} crowd) -> {args.out_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

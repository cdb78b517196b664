"""Sphere-bench: a controlled synthetic ERP detection dataset on disk.

    python -m sph_retina_tpu_torch.synth_dataset --root work_dirs/sphere_bench \\
        [--n-train 500] [--n-val 100] [--num-classes 12] \\
        [--img-size 256 512] [--box-version 4] [--seed 0]

Writes ``<root>/images/{split}_NNNNN.png`` and
``<root>/annotations/instances_{split}.json`` (COCO style, ``bbox`` =
[theta, phi, fov_x, fov_y] degrees, ``gamma`` appended for box_version 5;
each image entry carries a ``strata`` list of its "polar" / "seam"
content). Every object is painted at the exact spherical footprint of its
box: a pixel belongs to it iff the pixel's unit direction lies inside the
four great-circle half-spaces that bound the box, the inside test of the
unbiased IoU (``iou/unbiased.py``). Objects are polar (phi in [12, 38] or
[142, 168]), straddle the seam, or lie in the body; their FoVs are
log-uniform in [12, 85] degrees; a share of them gets an overlapping
partner painted after them (occlusion); each is a class colour under a
checker pattern and a brightness jitter, over a smooth noise background.

Host code, numpy float64 and PIL, as the JAX package's
``tools/synth_dataset.py``: the annotations' bytes depend on the exact
sequence of draws from ``np.random.default_rng(seed)`` (those made for
painting included) and the pixels on float64 ``dirs @ normals.T >= 0``, so
the published parameters (the defaults; val seeded ``seed + 10000``) give
the committed ``work_dirs/sphere_bench`` annotation files byte for byte.
An annotation file that exists with other bytes is never replaced: the
writer raises before it paints anything.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# 12 well-separated class colors (RGB).
CLASS_COLORS = np.array([
    [230, 60, 50], [60, 200, 60], [55, 90, 230], [240, 210, 50],
    [220, 60, 220], [60, 220, 220], [240, 140, 40], [140, 70, 220],
    [120, 220, 120], [220, 120, 140], [90, 150, 200], [200, 200, 200],
], np.uint8)

VAL_SEED_OFFSET = 10_000


def box_planes(box_deg: np.ndarray) -> np.ndarray:
    """Boundary plane normals (4, 3) of a BFoV/RBFoV box in degrees.

    The planes of ``iou/unbiased.py``, so that a painted footprint is the
    region the unbiased IoU integrates. A direction p is inside iff
    ``(p @ normals.T >= 0).all()``.
    """
    b = np.deg2rad(np.asarray(box_deg, np.float64))
    theta, phi, hx, hy = b[0], b[1], b[2] / 2.0, b[3] / 2.0
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    look = np.array([sp * ct, sp * st, cp])
    right = np.array([-st, ct, 0.0])
    up = np.array([-cp * ct, -cp * st, sp])
    shx, chx = np.sin(hx), np.cos(hx)
    shy, chy = np.sin(hy), np.cos(hy)
    normals = np.stack([
        -chx * right + shx * look,
        chx * right + shx * look,
        -chy * up + shy * look,
        chy * up + shy * look,
    ])
    if b.shape[0] == 5:  # RBFoV: rotate normals about the view axis
        g = b[4]
        cg, sg = np.cos(g), np.sin(g)
        cross = np.cross(np.broadcast_to(look, normals.shape), normals)
        dots = normals @ look
        normals = normals * cg + cross * sg + look[None] * dots[:, None] * (1 - cg)
    return normals


def erp_dirs(h: int, w: int) -> np.ndarray:
    """(H, W, 3) unit direction of each ERP pixel center.

    x = sin(phi) cos(theta), y = sin(phi) sin(theta), z = cos(phi);
    theta = x-pixel / W * 360, phi = y-pixel / H * 180 (colatitude, the
    equator at phi = 90).
    """
    theta = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    phi = (np.arange(h) + 0.5) / h * np.pi
    sp, cp = np.sin(phi)[:, None], np.cos(phi)[:, None]
    st, ct = np.sin(theta)[None, :], np.cos(theta)[None, :]
    return np.stack([sp * ct, sp * st, np.broadcast_to(cp, (h, w))], axis=-1)


def box_mask(dirs: np.ndarray, box_deg) -> np.ndarray:
    """(H, W) bool footprint of the box on the ERP grid."""
    normals = box_planes(np.asarray(box_deg))
    return (dirs @ normals.T >= 0.0).all(axis=-1)


def _coarse_grid(rng, h, w):
    """The background's random coarse grid: its one draw."""
    return rng.uniform(15, 75, (h // 16 + 2, w // 16 + 2, 3))


def _upsample(coarse, h, w):
    """Bilinear upsampling of the coarse grid to (H, W, 3) uint8."""
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    img = (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
           + c10 * fy * (1 - fx) + c11 * fy * fx)
    return img.astype(np.uint8)


def _smooth_background(rng, h, w):
    """Low-frequency noise background (bilinear-upsampled coarse grid)."""
    return _upsample(_coarse_grid(rng, h, w), h, w)


def _sample_box(rng, stratum: str, fov_range=(12.0, 85.0)):
    """One BFoV box (degrees) from a difficulty stratum."""
    lo, hi = np.log(fov_range[0]), np.log(fov_range[1])
    fx = float(np.exp(rng.uniform(lo, hi)))
    fy = float(np.clip(fx * np.exp(rng.uniform(-0.5, 0.5)),
                       fov_range[0], fov_range[1]))
    if stratum == "polar":
        phi = float(rng.uniform(12.0, 38.0)) if rng.random() < 0.5 \
            else float(rng.uniform(142.0, 168.0))
        theta = float(rng.uniform(0.0, 360.0))
    elif stratum == "seam":
        phi = float(rng.uniform(45.0, 135.0))
        theta = float(rng.uniform(-15.0, 15.0) % 360.0)
    else:
        phi = float(rng.uniform(40.0, 140.0))
        theta = float(rng.uniform(25.0, 335.0))
    return [theta, phi, fx, fy]


def _draw_image(rng, *, h, w, num_classes, boxes_per_image, polar_frac,
                seam_frac, occlusion_frac, box_version, fov_range):
    """Every draw one image takes, in the generator's order: the background
    grid, the boxes (each with its label and maybe an occluding partner),
    then a brightness jitter for each box in painting order. Returns
    (coarse grid, [(box, label, jitter)], strata)."""
    coarse = _coarse_grid(rng, h, w)
    n = int(rng.integers(boxes_per_image[0], boxes_per_image[1] + 1))
    strata = set()
    recs = []
    for _ in range(n):
        u = rng.random()
        stratum = ("polar" if u < polar_frac
                   else "seam" if u < polar_frac + seam_frac
                   else "body")
        box = _sample_box(rng, stratum, fov_range=fov_range)
        if box_version == 5:
            box.append(float(rng.uniform(-45.0, 45.0)))
        label = int(rng.integers(0, num_classes))
        recs.append((box, label))
        if stratum != "body":
            strata.add(stratum)
        # occlusion partner: overlaps `box`, painted after it
        if rng.random() < occlusion_frac:
            t, p, fx, fy = box[:4]
            part = [
                float((t + rng.uniform(-0.6, 0.6) * fx) % 360.0),
                float(np.clip(p + rng.uniform(-0.6, 0.6) * fy, 5.0, 175.0)),
                float(np.clip(fx * np.exp(rng.uniform(-0.4, 0.2)),
                              *fov_range)),
                float(np.clip(fy * np.exp(rng.uniform(-0.4, 0.2)),
                              *fov_range)),
            ]
            if box_version == 5:
                part.append(float(rng.uniform(-45.0, 45.0)))
            recs.append((part, int(rng.integers(0, num_classes))))
    painted = [(box, label, float(rng.uniform(0.85, 1.15)))
               for box, label in recs]
    return coarse, painted, strata


def write_sphere_bench(
    root: str,
    split: str = "train",
    n_images: int = 500,
    num_classes: int = 12,
    img_size=(256, 512),
    boxes_per_image=(2, 6),
    polar_frac: float = 0.35,
    seam_frac: float = 0.20,
    occlusion_frac: float = 0.30,
    box_version: int = 4,
    seed: int = 0,
    fov_range=(12.0, 85.0),
):
    """Write the split; returns (ann_file, img_dir).

    Deterministic in (seed, parameters). All draws are made and the
    annotation file's bytes settled before the first image is painted: an
    existing annotation file with other bytes raises ``FileExistsError``
    and nothing is written.
    """
    h, w = img_size
    img_dir = os.path.join(root, "images")
    ann_file = os.path.join(root, "annotations", f"instances_{split}.json")

    rng = np.random.default_rng(seed)
    drawn = [_draw_image(rng, h=h, w=w, num_classes=num_classes,
                         boxes_per_image=boxes_per_image,
                         polar_frac=polar_frac, seam_frac=seam_frac,
                         occlusion_frac=occlusion_frac,
                         box_version=box_version, fov_range=fov_range)
             for _ in range(n_images)]
    images, annotations = [], []
    for img_id, (_, painted, strata) in enumerate(drawn, start=1):
        for box, label, _ in painted:
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id,
                "category_id": label + 1,
                "bbox": [round(v, 4) for v in box],
                "area": round(box[2] * box[3], 2), "iscrowd": 0,
            })
        images.append({"id": img_id, "file_name": f"{split}_{img_id:05d}.png",
                       "width": w, "height": h, "strata": sorted(strata)})
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i + 1, "name": f"class_{i}"}
                       for i in range(num_classes)],
    }
    data = json.dumps(coco).encode()
    if os.path.exists(ann_file):
        with open(ann_file, "rb") as f:
            if f.read() != data:
                raise FileExistsError(
                    f"{ann_file} exists with other annotations than these "
                    f"parameters give ({n_images} images, {num_classes} "
                    f"classes, {h}x{w}, box_version {box_version}, seed "
                    f"{seed}); it is not replaced: remove it or write to "
                    f"another root")

    from PIL import Image

    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.dirname(ann_file), exist_ok=True)
    dirs = erp_dirs(h, w)
    checker = ((np.arange(h)[:, None] // 4 + np.arange(w)[None, :] // 4) % 2
               ).astype(np.float32) * 0.25 + 0.75  # (H, W) in {0.75, 1.0}
    for (coarse, painted, _), entry in zip(drawn, images):
        canvas = _upsample(coarse, h, w).astype(np.float32)
        for box, label, jitter in painted:  # later boxes overwrite: occlusion
            m = box_mask(dirs, box)
            color = CLASS_COLORS[label].astype(np.float32)
            canvas[m] = np.clip(color[None, :] * (checker[m] * jitter)[:, None],
                                0, 255)
        Image.fromarray(canvas.astype(np.uint8)).save(
            os.path.join(img_dir, entry["file_name"]))
    with open(ann_file, "wb") as f:
        f.write(data)
    return ann_file, img_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default="work_dirs/sphere_bench")
    p.add_argument("--n-train", type=int, default=500)
    p.add_argument("--n-val", type=int, default=100)
    p.add_argument("--num-classes", type=int, default=12)
    p.add_argument("--img-size", type=int, nargs=2, default=(256, 512))
    p.add_argument("--box-version", type=int, default=4, choices=(4, 5))
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for split, n, seed in (("train", args.n_train, args.seed),
                           ("val", args.n_val, args.seed + VAL_SEED_OFFSET)):
        ann, _ = write_sphere_bench(
            args.root, split=split, n_images=n,
            num_classes=args.num_classes, img_size=tuple(args.img_size),
            box_version=args.box_version, seed=seed)
        print(f"{split}: {n} images -> {ann}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

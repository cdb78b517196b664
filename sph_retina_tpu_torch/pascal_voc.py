"""Convert PASCAL VOC XML annotations to spherical COCO JSON.

    python -m sph_retina_tpu_torch.pascal_voc VOCdevkit/VOC2012/Annotations \\
        out.json [--img-dir JPEGImages] [--list ImageSets/Main/train.txt]

Writes the COCO-style JSON the data layer reads (``data/coco_sph.py``):
each planar pixel box is reinterpreted on the image's ERP chart and stored
as a BFoV in degrees (``chart_util.pix2bfov``). ``difficult`` objects
become ``iscrowd`` records, which the loader skips (the ignore split).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import xml.etree.ElementTree as ET

from .chart_util import pix2bfov

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def convert(xml_dir: str, out_file: str, img_dir: str = "",
            id_list: list[str] | None = None) -> dict:
    paths = sorted(glob.glob(os.path.join(xml_dir, "*.xml")))
    if id_list is not None:
        wanted = set(id_list)
        paths = [p for p in paths
                 if os.path.splitext(os.path.basename(p))[0] in wanted]
    images, annotations = [], []
    ann_id = 1
    for img_id, path in enumerate(paths, start=1):
        root = ET.parse(path).getroot()
        size = root.find("size")
        w = int(size.find("width").text)
        h = int(size.find("height").text)
        fname = root.findtext("filename") or (
            os.path.splitext(os.path.basename(path))[0] + ".jpg")
        images.append({"id": img_id,
                       "file_name": os.path.join(img_dir, fname)
                       if img_dir else fname,
                       "width": w, "height": h})
        for obj in root.findall("object"):
            name = obj.findtext("name")
            if name not in VOC_CLASSES:
                continue
            difficult = int(obj.findtext("difficult") or 0)
            bb = obj.find("bndbox")
            # VOC pixel indices are 1-based
            x1 = float(bb.findtext("xmin")) - 1
            y1 = float(bb.findtext("ymin")) - 1
            x2 = float(bb.findtext("xmax")) - 1
            y2 = float(bb.findtext("ymax")) - 1
            annotations.append({
                "id": ann_id, "image_id": img_id,
                "category_id": VOC_CLASSES.index(name) + 1,
                "bbox": pix2bfov(x1, y1, x2, y2, w, h),
                "iscrowd": difficult, "area": (x2 - x1) * (y2 - y1),
            })
            ann_id += 1
    out = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(VOC_CLASSES)],
    }
    with open(out_file, "w") as f:
        json.dump(out, f)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("xml_dir", help="directory of VOC Annotations/*.xml")
    p.add_argument("out_file", help="output COCO JSON")
    p.add_argument("--img-dir", default="",
                   help="prefix for file_name entries")
    p.add_argument("--list", default=None,
                   help="ImageSets id list restricting the split")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    ids = None
    if args.list:
        with open(args.list) as f:
            ids = [line.split()[0] for line in f if line.strip()]
    out = convert(args.xml_dir, args.out_file, args.img_dir, ids)
    print(f"{len(out['images'])} images, {len(out['annotations'])} "
          f"annotations -> {args.out_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

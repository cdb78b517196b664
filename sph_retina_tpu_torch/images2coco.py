"""Build an unannotated COCO-style JSON from a directory of ERP images.

    python -m sph_retina_tpu_torch.images2coco IMG_DIR CLASSES.txt OUT.json \\
        [--exclude-extensions png ..]

Lists the images (sorted by name), records their sizes (PIL reads the
headers) and writes a COCO JSON with the given classes (one a line) and no
annotations: the input of a test-time run over a raw image collection.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("img_dir")
    p.add_argument("classes", help="text file, one class name per line")
    p.add_argument("out", help="output annotation json filename")
    p.add_argument("--exclude-extensions", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from PIL import Image

    with open(args.classes) as f:
        classes = [line.strip() for line in f if line.strip()]
    excluded = tuple(e if e.startswith(".") else "." + e
                     for e in args.exclude_extensions)

    images = []
    for name in sorted(os.listdir(args.img_dir)):
        ext = os.path.splitext(name)[1].lower()
        if ext not in EXTS or (excluded and ext in excluded):
            continue
        with Image.open(os.path.join(args.img_dir, name)) as im:
            w, h = im.size
        images.append({"id": len(images), "file_name": name,
                       "width": w, "height": h})

    coco = {
        "images": images,
        "annotations": [],
        "categories": [{"id": i + 1, "name": c}
                       for i, c in enumerate(classes)],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(coco, f)
    print(f"{len(images)} images -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

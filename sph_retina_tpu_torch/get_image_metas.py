"""Collect image metadata (file name, width, height) for a dataset.

    python -m sph_retina_tpu_torch.get_image_metas --ann-file ANN.json \\
        --img-prefix IMGS/ --out metas.json [--workers 8]
    python -m sph_retina_tpu_torch.get_image_metas --img-dir IMGS/ --out metas.json

Reads the annotation file's image list, or scans a directory, takes each
file's size from its header (PIL, ``--workers`` threads) and writes a JSON
list of metas, so that a pipeline need not decode an image for its shape.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _size(path):
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ann-file", default=None)
    p.add_argument("--img-dir", default=None)
    p.add_argument("--img-prefix", default="")
    p.add_argument("--out", default="image_metas.json")
    p.add_argument("--workers", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.ann_file:
        with open(args.ann_file) as f:
            files = [im["file_name"] for im in json.load(f).get("images", [])]
        prefix = args.img_prefix
    elif args.img_dir:
        files = sorted(f for f in os.listdir(args.img_dir)
                       if os.path.splitext(f)[1].lower() in EXTS)
        prefix = args.img_dir
    else:
        raise SystemExit("need --ann-file or --img-dir")

    with ThreadPoolExecutor(args.workers) as ex:
        sizes = list(ex.map(_size,
                            (os.path.join(prefix, f) for f in files)))
    metas = [{"file_name": f, "width": w, "height": h}
             for f, (w, h) in zip(files, sizes)]
    with open(args.out, "w") as f:
        json.dump(metas, f)
    print(f"{len(metas)} metas -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

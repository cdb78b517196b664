"""Convert raw radian annotations to the package's degree format.

    python -m sph_retina_tpu_torch.convert_anno ANN.json [ANN2.json ..] \\
        [--out OUT.json]

Raw boxes are (lon in [-pi, pi], lat in [pi/2, -pi/2]) radians; the
package's boxes are theta in [0, 360), phi in [0, 180) degrees:

    theta = lon * 180/pi + 180
    phi   = 90 - lat * 180/pi

Each file is rewritten in place unless ``--out`` is given (one input only).
"""

from __future__ import annotations

import argparse
import json
import sys
from math import pi


def convert_box(box):
    box[0] = box[0] / pi * 180.0 + 180.0
    box[1] = 90.0 - box[1] / pi * 180.0
    return box


def convert_file(path: str, out: str | None = None):
    with open(path) as f:
        anno = json.load(f)
    for ann in anno.get("annotations", []):
        convert_box(ann["bbox"])
    with open(out or path, "w") as f:
        json.dump(anno, f)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="+")
    p.add_argument("--out", default=None,
                   help="output path (single input only); default: in place")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for path in args.paths:
        convert_file(path, args.out if len(args.paths) == 1 else None)
        print(f"converted {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Recall on occluded / ERP-seam-separated ground truth.

    python -m sph_retina_tpu_torch.occluded_recall raw.npz --out recall.json

Spherical-box counterpart of the reference's
``coco_occluded_separated_recall.py`` (which needs instance masks; see
``engine/analysis.py:occluded_separated_recall`` for the box-native
definitions), on the ``.npz`` of ``test.py --save-raw``. The IoU matrices
are computed on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

from .engine.analysis import load_raw_results, occluded_separated_recall
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Occluded / separated recall")
    p.add_argument("raw", help="npz from test.py --save-raw")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--iou-thr", type=float, default=0.75)
    p.add_argument("--occ-iou-thr", type=float, default=0.1)
    p.add_argument("--iou-backend", default="sph2pob_efficient")
    p.add_argument("--out", default=None, help="save the metrics as JSON")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    res = occluded_separated_recall(
        load_raw_results(args.raw), score_thr=args.score_thr,
        iou_thr=args.iou_thr, occ_iou_thr=args.occ_iou_thr,
        backend=args.iou_backend, device=resolve_device(args.device))
    for name in ("occluded", "separated", "all"):
        print(f"{name:>10}: recall "
              f"{res[f'{name}_recall']:.4f} over {res[f'{name}_total']} GT")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
        print(f"saved -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

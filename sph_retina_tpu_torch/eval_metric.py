"""Re-score saved raw results without running the detector again.

    python -m sph_retina_tpu_torch.test CONFIG CKPT --save-raw raw.npz
    python -m sph_retina_tpu_torch.eval_metric CONFIG raw.npz \\
        [--iou-backend unbiased] [--iou-thrs 0.5 0.75] [--voc] [--out m.json]

The counterpart of mmdet's ``eval_metric.py`` on the ``.npz`` of ``test.py
--save-raw``: COCO-style spherical AP (``engine/eval.py``), over
``--iou-thrs`` instead of 0.5:0.95 where given, or with ``--voc`` mmdet's
``eval_map`` at one threshold (the first of ``--iou-thrs``, else 0.5), so
that IoU backends and thresholds compare cheaply. The matcher's IoU
matrices are computed on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

from .engine.analysis import _unpack, load_raw_results
from .engine.eval import eval_spherical_map, eval_voc_map
from .utils.config import load_config
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Re-score raw results")
    p.add_argument("config")
    p.add_argument("raw", help="npz from test.py --save-raw")
    p.add_argument("--iou-backend", default="sph2pob_efficient")
    p.add_argument("--iou-thrs", type=float, nargs="*", default=None,
                   help="override the COCO 0.5:0.95 threshold sweep")
    p.add_argument("--voc", action="store_true",
                   help="VOC-style mAP (mmdet's eval_map, one threshold: "
                        "the first --iou-thrs or 0.5) instead of COCO-style")
    p.add_argument("--out", default=None, help="write metrics JSON here")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    num_classes = load_config(args.config)["model"]["num_classes"]
    arrays = load_raw_results(args.raw)

    det_results, annotations = [], []
    for i in range(arrays["boxes"].shape[0]):
        boxes, scores, labels, gt_boxes, gt_labels = _unpack(arrays, i)
        det_results.append((boxes, scores, labels))
        annotations.append({"boxes": gt_boxes, "labels": gt_labels})

    if args.voc:
        metrics = eval_voc_map(
            det_results, annotations, num_classes,
            iou_thr=(args.iou_thrs[0] if args.iou_thrs else 0.5),
            backend=args.iou_backend, device=device)
        summary = {"mAP": metrics["mAP"],
                   "per_class": metrics["per_class"]}
    else:
        kwargs = {}
        if args.iou_thrs:
            kwargs["iou_thrs"] = tuple(args.iou_thrs)
        metrics = eval_spherical_map(det_results, annotations, num_classes,
                                     backend=args.iou_backend, device=device,
                                     **kwargs)
        summary = {k: v for k, v in metrics.items() if isinstance(v, float)}
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

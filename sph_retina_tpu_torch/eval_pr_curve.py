"""Per-class precision-recall curves of a detector checkpoint.

    python -m sph_retina_tpu_torch.eval_pr_curve CONFIG CHECKPOINT \\
        --iou-thr 0.5 --out pr_curves.png [--synthetic]

Predicts the config's ``data.test`` split (``--synthetic``: 16 synthetic
images) with the checkpoint, as ``test.py`` does, through the family's
predict (its NMS on the CUDA device unless ``--device cpu`` is given), then
matches the detections of each class to its ground truth greedily in score
order over all images at ``--iou-thr`` (spherical IoU on the same device)
and plots each class's curve with its COCO 101-point AP
(``visualize/canvas.py``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .engine.analysis import _unpack
from .engine.eval import _average_precision, _pairwise_iou_np
from .engine.evaluator import evaluate_dataset
from .engine.zoo import get_family
from .test import eval_loader, load_for_eval
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device
from .visualize.canvas import CYCLE, Axes


def pr_curves(dets, anns, num_classes: int, iou_thr: float = 0.5,
              backend: str = "sph2pob_efficient", device=None) -> dict:
    """``{class: (recall, precision, ap)}`` for every class with ground
    truth. ``dets`` holds ``(boxes, scores, labels)`` an image, ``anns``
    ``{"boxes", "labels"}`` an image. Each class's detections over all
    images, in score order (stable), each take the unmatched ground truth
    of their image and class with the largest IoU if it reaches
    ``iou_thr``; ``ap`` is ``engine/eval.py:_average_precision`` of the
    curve. One IoU matrix an image and class, on ``device`` (``None``: the
    CUDA device)."""
    curves = {}
    for c in range(num_classes):
        records, ious, matched, n_gt = [], [], [], 0
        for i, ((boxes, scores, labels), ann) in enumerate(zip(dets, anns)):
            gt = np.asarray(ann["boxes"])[np.asarray(ann["labels"]) == c]
            det = np.flatnonzero(np.asarray(labels) == c)
            n_gt += len(gt)
            matched.append(np.zeros(len(gt), bool))
            ious.append(_pairwise_iou_np(np.asarray(boxes)[det], gt, backend,
                                         device))
            records += [(float(scores[k]), i, j) for j, k in enumerate(det)]
        if n_gt == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tp = np.zeros(len(records))
        for r, (_, i, j) in enumerate(records):
            if not matched[i].size:
                continue
            cand = np.where(~matched[i], ious[i][j], -1.0)
            best = int(np.argmax(cand))
            if cand[best] >= iou_thr:
                matched[i][best] = True
                tp[r] = 1
        ctp = np.cumsum(tp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(np.arange(1, len(records) + 1), 1)
        curves[c] = (recall, precision,
                     _average_precision(recall, precision))
    return curves


def plot_pr_curves(curves: dict, out_file: str) -> None:
    ax = Axes(600, 480, (0.0, 1.0), (0.0, 1.05), xlabel="recall",
              ylabel="precision")
    for i, (c, (recall, precision, ap)) in enumerate(curves.items()):
        ax.line(recall, precision, CYCLE[i % len(CYCLE)], width=2,
                label=f"class {c} (AP={ap:.3f})")
    ax.legend("upper right")
    ax.save(out_file)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Precision-recall curves")
    p.add_argument("config")
    p.add_argument("checkpoint",
                   help="checkpoint directory or one epoch_N file")
    p.add_argument("--iou-thr", type=float, default=0.5)
    p.add_argument("--iou-backend", default="sph2pob_efficient")
    p.add_argument("--out", default="pr_curves.png")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    loader = eval_loader(cfg, args.synthetic)
    model, det_cfg, _ = load_for_eval(cfg, args.checkpoint, device)
    _, arrays = evaluate_dataset(
        model, det_cfg, loader, backend=args.iou_backend,
        predict=get_family(cfg).predict_fn(model, det_cfg), return_raw=True)
    dets, anns = [], []
    for i in range(arrays["boxes"].shape[0]):
        boxes, scores, labels, gt_boxes, gt_labels = _unpack(arrays, i)
        dets.append((boxes, scores, labels))
        anns.append({"boxes": gt_boxes, "labels": gt_labels})
    curves = pr_curves(dets, anns, cfg["model"]["num_classes"],
                       args.iou_thr, args.iou_backend, device)
    for c, (_, _, ap) in curves.items():
        print(f"class {c}: AP={ap:.4f}")
    plot_pr_curves(curves, args.out)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

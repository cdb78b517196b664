"""COCO error-type decomposition with spherical IoU matching.

Counterpart of the reference's ``coco_error_analysis.py``: per class, a
ladder of precision / recall curves where each rung forgives one more
error source —

- ``C75``: strict matching at spherical IoU 0.75;
- ``C50``: at 0.50;
- ``Loc``: at 0.10 (localization errors forgiven);
- ``Oth``: additionally, detections overlapping a *different* class's GT at
  IoU >= 0.10 are ignored (class confusions forgiven; the reference's
  'Sim' supercategory rung collapses into this one: the spherical datasets
  define no supercategories);
- ``BG``: additionally, every remaining unmatched detection is ignored
  (precision 1 up to the recall achieved);
- ``FN``: 1.0 everywhere (missed GT forgiven).

The areas between consecutive curves say how much AP each error type
costs. The IoU matrices come from ``engine/eval.py:_pairwise_iou_np`` on
``device`` (``None``: the CUDA device); the rest is numpy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .eval import _pairwise_iou_np

ERROR_TYPES = ("C75", "C50", "Loc", "Oth", "BG", "FN")
RECALL_LEVELS = np.linspace(0.0, 1.0, 101)


def _precision_at_levels(tp, ignore, n_gt):
    """The monotone precision envelope at the 101 COCO recall levels.

    ``tp`` / ``ignore``: per-detection flags in score order; an ignored
    detection counts toward neither precision nor recall (pycocotools'
    gtIgnore / dtIgnore).
    """
    tp = tp[~ignore]
    if n_gt == 0:
        return np.zeros_like(RECALL_LEVELS)
    ctp = np.cumsum(tp)
    cfp = np.cumsum(~tp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.searchsorted(mrec, RECALL_LEVELS, side="left")
    return mpre[np.clip(idx, 0, len(mpre) - 1)]


def _match(recs, iou_sub, per_img_ngt, thr):
    """Greedy score-ordered matching: per-detection tp flags."""
    matched = {img: np.zeros(n, bool) for img, n in per_img_ngt.items()}
    tp = np.zeros(len(recs), bool)
    for r_i, (_, img, row) in enumerate(recs):
        ious = iou_sub[img][row]
        if ious.size == 0:
            continue
        cand = np.where(~matched[img], ious, -1.0)
        best = int(np.argmax(cand))
        if cand[best] >= thr:
            matched[img][best] = True
            tp[r_i] = True
    return tp


def error_decomposition(
    det_results: Sequence[tuple],
    annotations: Sequence[dict],
    num_classes: int,
    backend: str = "unbiased",
    max_dets: int = 100,
    device=None,
) -> dict:
    """Per-class precision curves of the error ladder.

    Arguments as :func:`~.eval.eval_spherical_map`'s; returns ``{"ps":
    (6, 101, num_classes), "valid": (num_classes,) bool, "ap": (6,
    num_classes)}``, ``ap`` being each curve's mean (the bracketed numbers
    in the reference's legend).
    """
    n_imgs = len(det_results)
    ordered, iou_mats = [], []
    for (boxes, scores, labels), ann in zip(det_results, annotations):
        order = np.argsort(-np.asarray(scores))[:max_dets]
        boxes = np.asarray(boxes)[order]
        ordered.append((boxes, np.asarray(scores)[order],
                        np.asarray(labels)[order]))
        iou_mats.append(_pairwise_iou_np(boxes, np.asarray(ann["boxes"]),
                                         backend, device))

    ps = np.zeros((len(ERROR_TYPES), len(RECALL_LEVELS), num_classes))
    valid = np.zeros(num_classes, bool)

    for c in range(num_classes):
        recs = []            # (score, img, row within class c's dets)
        iou_sub = {}         # img -> (n_dets_c, n_gt_c) IoU
        iou_other = {}       # img -> (n_dets_c,) best IoU vs other classes
        per_img_ngt = {}
        n_gt = 0
        for i in range(n_imgs):
            gt_labels = np.asarray(annotations[i]["labels"])
            gt_idx = np.where(gt_labels == c)[0]
            other_idx = np.where(gt_labels != c)[0]
            _, scores, labels = ordered[i]
            det_idx = np.where(labels == c)[0]
            iou_sub[i] = iou_mats[i][np.ix_(det_idx, gt_idx)]
            oth = iou_mats[i][np.ix_(det_idx, other_idx)]
            iou_other[i] = (oth.max(axis=1) if oth.size
                            else np.zeros(len(det_idx)))
            per_img_ngt[i] = len(gt_idx)
            n_gt += len(gt_idx)
            for row, k in enumerate(det_idx):
                recs.append((float(scores[k]), i, row))
        if n_gt == 0:
            continue
        valid[c] = True
        recs.sort(key=lambda r: -r[0])
        no_ignore = np.zeros(len(recs), bool)

        for t_i, thr in enumerate((0.75, 0.5, 0.1)):
            tp = _match(recs, iou_sub, per_img_ngt, thr)
            ps[t_i, :, c] = _precision_at_levels(tp, no_ignore, n_gt)

        # Oth: unmatched dets overlapping another class's GT are ignored
        tp_loc = _match(recs, iou_sub, per_img_ngt, 0.1)
        confused = np.array([
            (not tp_loc[r_i]) and iou_other[img][row] >= 0.1
            for r_i, (_, img, row) in enumerate(recs)], bool)
        ps[3, :, c] = _precision_at_levels(tp_loc, confused, n_gt)

        # BG: every remaining FP ignored
        ps[4, :, c] = _precision_at_levels(tp_loc, ~tp_loc, n_gt)

        # FN: misses forgiven too
        ps[5, :, c] = 1.0

    return {"ps": ps, "valid": valid, "ap": ps.mean(axis=1)}

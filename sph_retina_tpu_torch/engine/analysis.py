"""Result analysis: confusion matrix, per-image scores, hard-subset recall.

Counterparts of the reference's analysis tools (``confusion_matrix.py``,
``analyze_results.py``, ``coco_occluded_separated_recall.py``), on the
padded result arrays that ``test.py --save-raw`` writes (boxes / scores /
labels / valid, the padded ground truth and ignore regions, and ``img_id``,
one row an image; the JAX package's ``.npz`` layout, so that each package
reads the other's file), with spherical-IoU matching throughout. The IoU
matrices come from ``engine/eval.py:_pairwise_iou_np`` on ``device``
(``None``: the CUDA device); the rest is numpy.
"""

from __future__ import annotations

import numpy as np

from .eval import _pairwise_iou_np, eval_spherical_map


def _unpack(arrays: dict, i: int):
    """Row ``i``'s valid detections and ground truth: (det boxes, scores,
    det labels, gt boxes, gt labels)."""
    v = arrays["valid"][i].astype(bool)
    m = arrays["gt_mask"][i].astype(bool)
    return (arrays["boxes"][i][v], arrays["scores"][i][v],
            arrays["labels"][i][v].astype(int),
            arrays["gt_boxes"][i][m], arrays["gt_labels"][i][m].astype(int))


def confusion_matrix(
    arrays: dict,
    num_classes: int,
    *,
    score_thr: float = 0.3,
    iou_thr: float = 0.5,
    backend: str = "sph2pob_efficient",
    device=None,
) -> np.ndarray:
    """(C+1, C+1) confusion matrix; row = GT class, col = predicted class.

    Row C = background (false positives land in [C, pred]); col C = missed
    GT ([gt, C]). Matching: per image, detections score-descending, each
    claims the highest-IoU unmatched GT above ``iou_thr`` regardless of
    class (the reference's ``analyze_per_img_dets``: one pass over the
    detections at ``tp_iou_thr``).
    """
    cm = np.zeros((num_classes + 1, num_classes + 1), np.int64)
    for i in range(arrays["boxes"].shape[0]):
        det_boxes, scores, det_labels, gt_boxes, gt_labels = _unpack(arrays, i)
        keep = scores >= score_thr
        det_boxes, scores, det_labels = (det_boxes[keep], scores[keep],
                                         det_labels[keep])
        order = np.argsort(-scores)
        det_boxes, det_labels = det_boxes[order], det_labels[order]
        iou = _pairwise_iou_np(det_boxes, gt_boxes, backend, device)
        gt_matched = np.zeros(len(gt_boxes), bool)
        for k in range(len(det_boxes)):
            best = -1
            if len(gt_boxes):
                best = int(np.argmax(np.where(gt_matched, -1.0, iou[k])))
            if best >= 0 and iou[k, best] >= iou_thr and not gt_matched[best]:
                gt_matched[best] = True
                cm[gt_labels[best], det_labels[k]] += 1
            else:
                cm[num_classes, det_labels[k]] += 1  # background FP
        for g in np.where(~gt_matched)[0]:
            cm[gt_labels[g], num_classes] += 1  # missed GT
    return cm


def per_image_scores(
    arrays: dict,
    num_classes: int,
    *,
    backend: str = "sph2pob_efficient",
    iou_thrs=(0.5,),
    device=None,
) -> np.ndarray:
    """Per-image AP (default AP50): the ranking key of the reference's
    ``analyze_results.py`` (good / bad prediction galleries)."""
    n = arrays["boxes"].shape[0]
    out = np.zeros(n)
    for i in range(n):
        det_boxes, scores, det_labels, gt_boxes, gt_labels = _unpack(arrays, i)
        res = eval_spherical_map(
            [(det_boxes, scores, det_labels)],
            [{"boxes": gt_boxes, "labels": gt_labels}],
            num_classes, iou_thrs=tuple(iou_thrs), backend=backend,
            device=device)
        out[i] = res["mAP"]
    return out


def occluded_separated_recall(
    arrays: dict,
    *,
    score_thr: float = 0.3,
    iou_thr: float = 0.75,
    occ_iou_thr: float = 0.1,
    backend: str = "sph2pob_efficient",
    device=None,
) -> dict:
    """Recall on two hard GT subsets, with box-native definitions.

    The reference tool (arXiv:2210.10046) measures recall on mask-occluded
    and mask-separated COCO instances and needs instance masks. Kept here
    is the intent, recall on the two structurally hard subsets:

    - **occluded**: a GT whose spherical IoU with another GT of the same
      image is >= ``occ_iou_thr``;
    - **separated**: a GT whose ERP footprint crosses the theta = 0/360
      seam (theta ± alpha/2 wraps), drawn as two pixel fragments.

    A GT counts as recalled when a same-class detection with score >=
    ``score_thr`` has spherical IoU >= ``iou_thr`` with it (the reference's
    defaults 0.3 / 0.75).
    """
    counts = {"occluded": [0, 0], "separated": [0, 0], "all": [0, 0]}
    for i in range(arrays["boxes"].shape[0]):
        det_boxes, scores, det_labels, gt_boxes, gt_labels = _unpack(arrays, i)
        keep = scores >= score_thr
        det_boxes, det_labels = det_boxes[keep], det_labels[keep]
        g = len(gt_boxes)
        if g == 0:
            continue
        if g > 1:
            gg = np.array(_pairwise_iou_np(gt_boxes, gt_boxes, backend,
                                           device))
            np.fill_diagonal(gg, 0.0)
            occluded = gg.max(axis=1) >= occ_iou_thr
        else:
            occluded = np.zeros(g, bool)
        half = gt_boxes[:, 2] / 2.0
        separated = (gt_boxes[:, 0] - half < 0.0) | \
            (gt_boxes[:, 0] + half > 360.0)
        if len(det_boxes):
            iou = _pairwise_iou_np(det_boxes, gt_boxes, backend, device)
            same = det_labels[:, None] == gt_labels[None, :]
            recalled = ((iou >= iou_thr) & same).any(axis=0)
        else:
            recalled = np.zeros(g, bool)
        for name, mask in (("occluded", occluded), ("separated", separated),
                           ("all", np.ones(g, bool))):
            counts[name][0] += int(recalled[mask].sum())
            counts[name][1] += int(mask.sum())
    out = {}
    for name, (rec, tot) in counts.items():
        out[f"{name}_recall"] = rec / tot if tot else float("nan")
        out[f"{name}_total"] = tot
    return out


def save_raw_results(path: str, arrays: dict) -> None:
    np.savez_compressed(path, **arrays)


def load_raw_results(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}

"""COCO-style AP evaluation with spherical IoU matching.

The COCO ``bbox`` metrics (AP, AP50, AP75) where the detection-GT matcher
uses a spherical IoU: per class and IoU threshold, score-ordered greedy
matching, 101-point interpolated AP — pycocotools' semantics. The IoU
matrix comes from ``iou.api.sph_overlaps`` (any backend, plain PyTorch, the
unfused Sph2Pob for ``sph2pob_efficient``, never the fused kernel) on the
device the caller gives, in fp32, under the OOM ladder (``utils/memory.py``),
read back once an image; everything after it is numpy in float64.

Crowd / ignore regions (COCO ``iscrowd``): annotations may carry
``ignore_boxes`` / ``ignore_labels``. Ignored GT contributes no recall
denominator, and a detection that fails to match a real GT but overlaps a
same-class ignore region (intersection-over-detection-area >= threshold,
pycocotools' crowd IoU) is *excluded* from scoring — neither TP nor FP.

The per-(image, class) greedy matcher is vectorised: one pass over the
detections (score order), each step an array op over all IoU thresholds and
GTs at once, and the TP/FP accumulation is a cumsum.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..iou.api import sph_overlaps
from ..utils.device import resolve_device
from ..utils.memory import AvoidOOM

COCO_IOU_THRS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


@torch.no_grad()
def _matcher_overlaps(dets, gts, backend):
    return sph_overlaps(dets, gts, backend)


# Device-OOM ladder (gc -> bf16 -> CPU) for very large det x gt matrices,
# the reference's AvoidCUDAOOM around test-time ops. The fallbacks that
# change numerics (bf16) warn, so a precision change in the matching is
# never silent.
_guarded_overlaps = AvoidOOM()(_matcher_overlaps)


def _pairwise_iou_np(det_boxes, gt_boxes, backend, device=None):
    """IoU matrix (n_det, n_gt), fp32, computed on ``device`` (``None``:
    the CUDA device) under ``AvoidOOM``."""
    n_det, n_gt = len(det_boxes), len(gt_boxes)
    if n_det == 0 or n_gt == 0:
        return np.zeros((n_det, n_gt), np.float32)
    device = resolve_device(device)
    dets = torch.as_tensor(np.asarray(det_boxes, np.float32), device=device)
    gts = torch.as_tensor(np.asarray(gt_boxes, np.float32), device=device)
    return _guarded_overlaps(dets, gts, backend).cpu().numpy()


def _box_area_np(boxes: np.ndarray) -> np.ndarray:
    """Exact spherical-rectangle area (steradians) from degree FoVs."""
    a = np.radians(boxes[:, 2].astype(np.float64))
    b = np.radians(boxes[:, 3].astype(np.float64))
    s = np.clip(-np.sin(a / 2.0) * np.sin(b / 2.0), -1.0, 1.0)
    return np.maximum(4.0 * np.arccos(s) - 2.0 * np.pi, 1e-12)


def _iof_from_iou(iou, det_boxes, ig_boxes):
    """Intersection-over-detection-area from the IoU and the exact areas:
    pycocotools' crowd "IoU" is I / area(det), and I = iou * (a_det + a_ig)
    / (1 + iou)."""
    iou = np.asarray(iou, np.float64)
    a_d = _box_area_np(np.asarray(det_boxes))[:, None]
    a_g = _box_area_np(np.asarray(ig_boxes))[None, :]
    inter = iou * (a_d + a_g) / (1.0 + iou)
    return np.clip(inter / a_d, 0.0, 1.0).astype(np.float32)


def _pairwise_iof_np(det_boxes, ig_boxes, backend, device=None):
    """Intersection-over-detection-area vs ignore regions."""
    if len(det_boxes) == 0 or len(ig_boxes) == 0:
        return np.zeros((len(det_boxes), len(ig_boxes)), np.float32)
    iou = _pairwise_iou_np(det_boxes, ig_boxes, backend, device)
    return _iof_from_iou(iou, det_boxes, ig_boxes)


def _average_precision(recall, precision):
    """COCO 101-point interpolated AP."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    levels = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(mrec, levels, side="left")
    return float(np.mean(mpre[np.clip(idx, 0, len(mpre) - 1)]))


def _greedy_match_image(ious, iof_max, thrs):
    """Greedy score-ordered matching for one image's class-c detections.

    Args:
        ious: (D, G) IoU vs non-ignored class-c GT; det rows score-descending.
        iof_max: (D,) max intersection-over-det-area vs ignored class-c GT
            (zeros when there are none).
        thrs: (T,) IoU thresholds.

    Returns:
        tp (T, D) bool — detection matched a free GT at that threshold;
        ign (T, D) bool — unmatched but overlapping an ignore region
            (excluded from both TP and FP).

    One python step per detection; everything inside is vectorised over
    thresholds x GTs (each claim locks a GT for the detections after it, but
    the thresholds are independent).
    """
    thrs = np.asarray(thrs, np.float64)
    T, (D, G) = len(thrs), ious.shape
    tp = np.zeros((T, D), bool)
    ign = np.zeros((T, D), bool)
    if D == 0:
        return tp, ign
    if G == 0:
        ign[:] = iof_max[None, :] >= thrs[:, None]
        return tp, ign
    matched = np.zeros((T, G), bool)
    t_idx = np.arange(T)
    for d in range(D):
        cand = np.where(matched, -1.0, ious[d][None, :])  # (T, G)
        best = cand.argmax(axis=1)
        ok = cand[t_idx, best] >= thrs
        matched[ok, best[ok]] = True
        tp[:, d] = ok
        ign[:, d] = ~ok & (iof_max[d] >= thrs)
    return tp, ign


def _as_boxes(boxes, d: int) -> np.ndarray:
    return np.asarray(boxes, np.float32).reshape(-1, d)


def eval_spherical_map(
    det_results: Sequence[tuple],
    annotations: Sequence[dict],
    num_classes: int,
    iou_thrs: Sequence[float] = COCO_IOU_THRS,
    backend: str = "unbiased",
    max_dets: int = 100,
    device=None,
) -> dict:
    """COCO-style mAP over spherical boxes.

    Args:
        det_results: per image (boxes (K, D), scores (K,), labels (K,))
            numpy arrays (invalid rows removed or scored 0).
        annotations: per image dicts with 'boxes' (G, D) and 'labels' (G,),
            plus optional 'ignore_boxes' (I, D) / 'ignore_labels' (I,)
            crowd/ignore regions (COCO iscrowd).
        num_classes: number of foreground classes.
        backend: spherical IoU backend used for matching.
        device: where the IoU matrices are computed (``None``: the CUDA
            device).

    Returns:
        dict with 'mAP' (AP@[.5:.95]), 'AP50', 'AP75', 'per_class' array.
    """
    n_imgs = len(det_results)
    assert len(annotations) == n_imgs
    thrs = np.asarray(list(iou_thrs), np.float64)
    n_thrs = len(thrs)

    # Score-order (and cap) each image's detections once, then one IoU
    # matrix an image: detections x (gts, then ignore regions).
    ordered, iou_mats, iof_mats = [], [], []
    for (boxes, scores, labels), ann in zip(det_results, annotations):
        order = np.argsort(-np.asarray(scores), kind="stable")[:max_dets]
        boxes = np.asarray(boxes)[order]
        ordered.append((boxes, np.asarray(scores)[order],
                        np.asarray(labels)[order]))
        d = boxes.shape[1] if boxes.ndim == 2 else 4
        gt = _as_boxes(ann["boxes"], d)
        ig = _as_boxes(ann.get("ignore_boxes", np.zeros((0, d))), d)
        iou = _pairwise_iou_np(boxes, np.concatenate([gt, ig]), backend,
                               device)
        iou_mats.append(iou[:, :len(gt)])
        iof_mats.append(_iof_from_iou(iou[:, len(gt):], boxes, ig)
                        if len(boxes) and len(ig)
                        else np.zeros((len(boxes), len(ig)), np.float32))

    ap = np.zeros((n_thrs, num_classes))
    valid_class = np.zeros(num_classes, bool)

    for c in range(num_classes):
        scores_c, tp_c, ign_c = [], [], []
        n_gt_total = 0
        for i in range(n_imgs):
            ann = annotations[i]
            gt_idx = np.where(np.asarray(ann["labels"]) == c)[0]
            n_gt_total += len(gt_idx)
            _, scores, labels = ordered[i]
            det_idx = np.where(labels == c)[0]
            if len(det_idx) == 0:
                continue
            ig_labels = np.asarray(ann.get("ignore_labels",
                                           np.zeros((0,), np.int32)))
            ig_idx = np.where(ig_labels == c)[0]
            iof = iof_mats[i][det_idx][:, ig_idx]
            iof_max = iof.max(axis=1) if iof.size else np.zeros(len(det_idx))
            tp, ign = _greedy_match_image(
                iou_mats[i][det_idx][:, gt_idx], iof_max, thrs)
            scores_c.append(scores[det_idx])
            tp_c.append(tp)
            ign_c.append(ign)
        if n_gt_total == 0:
            continue
        valid_class[c] = True
        if scores_c:
            scores_all = np.concatenate(scores_c)
            tp_all = np.concatenate(tp_c, axis=1)
            ign_all = np.concatenate(ign_c, axis=1)
            order = np.argsort(-scores_all, kind="stable")
            tp_all = tp_all[:, order]
            ign_all = ign_all[:, order]
            for t_i in range(n_thrs):
                keep = ~ign_all[t_i]
                tp_t = tp_all[t_i, keep].astype(np.float64)
                ctp = np.cumsum(tp_t)
                cfp = np.cumsum(1.0 - tp_t)
                recall = ctp / n_gt_total
                precision = ctp / np.maximum(ctp + cfp, 1e-9)
                ap[t_i, c] = _average_precision(recall, precision)

    mean_over_cls = ap[:, valid_class].mean(axis=1) if valid_class.any() \
        else np.zeros(n_thrs)
    thr_list = [float(t) for t in thrs]
    return {
        "mAP": float(mean_over_cls.mean()),
        "AP50": float(mean_over_cls[thr_list.index(0.5)])
        if 0.5 in thr_list else None,
        "AP75": float(mean_over_cls[thr_list.index(0.75)])
        if 0.75 in thr_list else None,
        "per_class": ap,
        "valid_classes": valid_class,
    }


# --------------------------------------------------------------------------- #
# VOC-style mAP (mmdet's eval_map)
# --------------------------------------------------------------------------- #
def _voc_average_precision(recalls, precisions, mode="area"):
    """mmdet ``average_precision``, single scale."""
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        mpre = np.maximum.accumulate(mpre[::-1])[::-1]
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    if mode == "11points":
        ap = 0.0
        for thr in np.arange(0.0, 1.0 + 1e-3, 0.1):
            precs = precisions[recalls >= thr]
            ap += float(precs.max()) if precs.size else 0.0
        return ap / 11.0
    raise ValueError(f"unknown AP mode {mode!r}")


def _voc_tpfp(ious, gt_ignore_inds, scores, iou_thr):
    """mmdet ``tpfp_default`` matching (no area ranges): detections in
    score order each claim their *global* max-IoU GT — ignored GT absorbs
    the detection (neither TP nor FP), an already-covered GT makes it an FP
    (VOC semantics; COCO instead rematches to the best free GT)."""
    num_dets, num_gts = ious.shape
    tp = np.zeros(num_dets, np.float32)
    fp = np.zeros(num_dets, np.float32)
    if num_gts == 0:
        fp[:] = 1
        return tp, fp
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    gt_covered = np.zeros(num_gts, bool)
    for i in np.argsort(-scores):
        if ious_max[i] >= iou_thr:
            matched = ious_argmax[i]
            if not gt_ignore_inds[matched]:
                if not gt_covered[matched]:
                    gt_covered[matched] = True
                    tp[i] = 1
                else:
                    fp[i] = 1
            # ignored GT: neither tp nor fp
        else:
            fp[i] = 1
    return tp, fp


def eval_voc_map(
    det_results: Sequence[tuple],
    annotations: Sequence[dict],
    num_classes: int,
    *,
    iou_thr: float = 0.5,
    backend: str = "unbiased",
    ap_mode: str = "area",
    device=None,
) -> dict:
    """VOC-style mAP with spherical IoU matching: mmdet's ``eval_map`` with
    ``tpfp_default`` — one IoU threshold, a per-class PR curve over all
    images, area-under-PR (or 11-point) AP, mAP over the classes with GT.
    Inputs as :func:`eval_spherical_map`."""
    n_imgs = len(det_results)
    assert len(annotations) == n_imgs
    per_class = []
    aps = []
    for c in range(num_classes):
        tps, fps, scores_all = [], [], []
        num_gts = 0
        num_dets = 0
        for (boxes, scores, labels), ann in zip(det_results, annotations):
            labels = np.asarray(labels)
            det_idx = np.where(labels == c)[0]
            det_boxes = np.asarray(boxes)[det_idx]
            det_scores = np.asarray(scores)[det_idx]
            gt = np.asarray(ann["boxes"])[np.asarray(ann["labels"]) == c]
            ig_labels = np.asarray(
                ann.get("ignore_labels", np.zeros((0,), np.int32)))
            ig = np.asarray(ann.get("ignore_boxes",
                                    np.zeros((0, gt.shape[-1] if gt.size
                                              else 4), np.float32)))
            ig = ig[ig_labels == c] if len(ig_labels) else ig[:0]
            # both sides as (n, D) before concatenating: an empty
            # ann['boxes'] list arrives as shape (0,)
            dim = (gt.shape[-1] if gt.ndim == 2 and gt.size else
                   (ig.shape[-1] if ig.ndim == 2 and ig.size else 4))
            gt = gt.reshape(-1, dim).astype(np.float32)
            ig = ig.reshape(-1, dim).astype(np.float32)
            num_gts += len(gt)
            num_dets += len(det_idx)
            stacked = np.concatenate([gt, ig])
            ignore_inds = np.concatenate(
                [np.zeros(len(gt), bool), np.ones(len(ig), bool)])
            ious = _pairwise_iou_np(det_boxes, stacked, backend, device)
            tp, fp = _voc_tpfp(ious, ignore_inds, det_scores, iou_thr)
            tps.append(tp)
            fps.append(fp)
            scores_all.append(det_scores)
        scores_cat = np.concatenate(scores_all) if scores_all else \
            np.zeros((0,))
        order = np.argsort(-scores_cat)
        tp_cum = np.cumsum(np.concatenate(tps)[order]) if len(order) else \
            np.zeros((0,))
        fp_cum = np.cumsum(np.concatenate(fps)[order]) if len(order) else \
            np.zeros((0,))
        eps = np.finfo(np.float32).eps
        recalls = tp_cum / max(num_gts, eps)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, eps)
        ap_c = _voc_average_precision(recalls, precisions, ap_mode)
        per_class.append({
            "num_gts": num_gts,
            "num_dets": num_dets,
            "recall": float(recalls[-1]) if len(recalls) else 0.0,
            "precision": float(precisions[-1]) if len(precisions) else 0.0,
            "ap": ap_c,
        })
        if num_gts > 0:
            aps.append(ap_c)
    return {
        "mAP": float(np.mean(aps)) if aps else 0.0,
        "per_class": per_class,
    }

"""Spherical and planar NMS as fixed-shape masked suppression.

1. top-k pre-selection (``nms_pre`` candidates, score-descending),
2. one (k, k) IoU matrix — the fused CUDA pairwise kernel for
   ``sph2pob_efficient``, ``sph_overlaps`` (plain PyTorch) for the other
   spherical backends, a chart IoU for the planar path (rotated-box IoU for
   5-dof boxes),
3. exact greedy suppression as a few vectorised sweeps over the matrix
   (classes kept apart by masking it, since spherical boxes cannot use the
   coordinate-offset trick),
4. top-``max_num`` of the survivors, returned as fixed-size tensors + mask.

Soft-NMS (``sph_batched_soft_nms``) shares steps 1-2 and then decays scores
instead of removing boxes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch._higher_order_ops.while_loop import while_loop_op

from ..iou.api import canonical_backend, sph_overlaps
from ..iou.rotated import rotated_box_iou
from ..ops.sph2pob_iou import sph2pob_iou_pairwise
from .formator import sph2planar_boxes

NEG_INF = -1e10


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (max_num, D) spherical degrees
    scores: torch.Tensor   # (max_num,)
    labels: torch.Tensor   # (max_num,) int32
    inds: torch.Tensor     # (max_num,) indices into the input tensors
    valid: torch.Tensor    # (max_num,) bool


def _pairwise_iou(boxes: torch.Tensor, backend: str) -> torch.Tensor:
    if backend in ("planar", "planar_nms"):
        planar = sph2planar_boxes(boxes)
        if planar.shape[-1] != 4:  # (x, y, w, h, angle) rotated boxes
            return rotated_box_iou(planar[:, None, :], planar[None, :, :])
        lt = torch.maximum(planar[:, None, :2], planar[None, :, :2])
        rb = torch.minimum(planar[:, None, 2:], planar[None, :, 2:])
        wh = (rb - lt).clamp_min(0.0)
        inter = wh[..., 0] * wh[..., 1]
        area = (planar[:, 2] - planar[:, 0]) * (planar[:, 3] - planar[:, 1])
        return inter / (area[:, None] + area[None, :] - inter + 1e-8)
    if canonical_backend(backend) == "sph2pob_efficient":
        boxes = boxes.float().contiguous()
        return sph2pob_iou_pairwise(boxes, boxes)
    return sph_overlaps(boxes, boxes, backend)


def _greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                     thr: float) -> torch.Tensor:
    """Exact score-descending greedy NMS over a pre-sorted candidate set.

    Greedy NMS is the unique fixpoint of the dominance recurrence
    ``keep[i] = valid[i] and not any(j < i, keep[j], iou[j, i] > thr)``
    (unique by strong induction on the score order). Iterating the map from
    ``keep = valid`` settles the first undecided box every sweep, so it
    reaches that fixpoint in at most chain-depth sweeps — a handful in
    practice — each one (k, k) masked reduction. A k-step sequential scan
    would be k tiny kernels in a row.

    The loop is the ``while_loop`` higher-order op, carrying ``(keep, prev,
    it)`` with the JAX package's condition ``any(keep != prev) & (it <=
    k)``, so that ``torch.export`` keeps it as one loop node. Eagerly the op
    reads its condition back once a sweep; the first sweep runs before the
    loop, so that is one read-back a sweep, as many as sweeps.
    """
    k = iou.shape[0]
    dom = (iou > thr).triu(diagonal=1)  # row j can kill column i > j

    def sweep(keep, dom, valid):
        return valid & ~(dom & keep[:, None]).any(dim=0)

    def cond(keep, prev, it, dom, valid):
        return (keep != prev).any() & (it <= k)

    def body(keep, prev, it, dom, valid):
        # carried outputs may not alias the inputs: prev is a copy
        return sweep(keep, dom, valid), keep.clone(), it + 1

    one = torch.ones((), dtype=torch.int64, device=iou.device)
    keep, _, _ = while_loop_op(cond, body, (sweep(valid, dom, valid), valid,
                                            one), (dom, valid))
    return keep


def sph_batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    *,
    iou_threshold: float = 0.5,
    max_num: int = 100,
    nms_pre: int = 1000,
    backend: str = "sph2pob_efficient",
    class_agnostic: bool = False,
    valid_mask: torch.Tensor | None = None,
) -> NMSResult:
    """Per-class greedy NMS with a spherical (or planar-chart) IoU backend.

    Args:
        boxes: (N, 4|5) spherical boxes, degrees.
        scores: (N,) confidence scores.
        idxs: (N,) int class ids (suppression only within a class unless
            ``class_agnostic``).
        valid_mask: optional (N,) validity of padded inputs.
    """
    n = boxes.shape[0]
    k = min(nms_pre, n)
    s = scores if valid_mask is None else torch.where(valid_mask, scores, NEG_INF)

    # stable sort, not topk: equal scores (frequent when the head runs in
    # bf16) keep their input order, so the greedy order is defined
    top_scores, order = torch.sort(s, descending=True, stable=True)
    top_scores, order = top_scores[:k], order[:k]
    top_boxes = boxes[order]
    top_idxs = idxs[order]

    iou = _pairwise_iou(top_boxes, backend)
    if not class_agnostic:
        same = top_idxs[:, None] == top_idxs[None, :]
        iou = torch.where(same, iou, 0.0)

    keep = _greedy_suppress(iou, top_scores > NEG_INF / 2, iou_threshold)

    m = min(max_num, k)
    final_scores, sel = torch.sort(torch.where(keep, top_scores, NEG_INF),
                                   descending=True, stable=True)
    final_scores, sel = final_scores[:m], sel[:m]
    valid = final_scores > NEG_INF / 2
    return NMSResult(
        boxes=top_boxes[sel],
        scores=torch.where(valid, final_scores, 0.0),
        labels=torch.where(valid, top_idxs[sel], -1).to(torch.int32),
        inds=order[sel],
        valid=valid,
    )


def planar_batched_nms(boxes, scores, idxs, **kwargs) -> NMSResult:
    """PlanarNMS: suppression in the chart, spherical boxes returned."""
    kwargs["backend"] = "planar"
    return sph_batched_nms(boxes, scores, idxs, **kwargs)


def sph_batched_soft_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    *,
    iou_threshold: float = 0.3,
    sigma: float = 0.5,
    min_score: float = 1e-3,
    method: str = "linear",
    max_num: int = 100,
    nms_pre: int = 1000,
    backend: str = "sph2pob_efficient",
    class_agnostic: bool = False,
    valid_mask: torch.Tensor | None = None,
) -> NMSResult:
    """Soft-NMS with a spherical (or planar-chart) IoU backend.

    Instead of removing overlapping boxes, each picked box decays the scores
    of its overlaps: ``linear``: ``s *= 1 - iou`` where ``iou >
    iou_threshold``; ``gaussian``: ``s *= exp(-iou^2 / sigma)`` (Bodla et
    al., ICCV 2017). Picks below ``min_score`` are invalid.

    Only the first ``max_num`` picks can reach the output (a pick's score is
    frozen when it is picked and scores only decrease), so ``max_num``
    argmax + decay sweeps over the (k,) score vector are exact. The picked
    index stays a tensor on the device: no sweep waits for it.
    """
    n = boxes.shape[0]
    k = min(nms_pre, n)
    s = scores if valid_mask is None else torch.where(valid_mask, scores,
                                                      NEG_INF)

    top_scores, order = torch.sort(s, descending=True, stable=True)
    top_scores, order = top_scores[:k], order[:k]
    top_boxes = boxes[order]
    top_idxs = idxs[order]

    iou = _pairwise_iou(top_boxes, backend)
    if not class_agnostic:
        same = top_idxs[:, None] == top_idxs[None, :]
        iou = torch.where(same, iou, 0.0)
    # a box never decays itself
    iou = iou * (1.0 - torch.eye(k, dtype=iou.dtype, device=iou.device))

    if method == "linear":
        decay = torch.where(iou > iou_threshold, 1.0 - iou, 1.0)
    elif method == "gaussian":
        decay = torch.exp(-(iou * iou) / sigma)
    else:
        raise ValueError(f"soft-NMS method {method!r}")

    m = min(max_num, k)
    live = torch.where(top_scores > NEG_INF / 2, top_scores, NEG_INF)
    picks = [torch.zeros((0,), dtype=torch.int64, device=live.device)]
    picked_scores = [live[:0]]
    for _ in range(m):
        j = live.argmax(dim=0, keepdim=True)            # (1,), the first max
        sj = live.gather(0, j)
        picks.append(j)
        picked_scores.append(sj)
        live = live * torch.where(sj > NEG_INF / 2, decay.index_select(0, j)[0],
                                  1.0)
        live = live.index_fill(0, j, NEG_INF)
    sel = torch.cat(picks)
    final_scores = torch.cat(picked_scores)
    valid = final_scores > max(min_score, NEG_INF / 2)
    return NMSResult(
        boxes=top_boxes[sel],
        scores=torch.where(valid, final_scores, 0.0),
        labels=torch.where(valid, top_idxs[sel], -1).to(torch.int32),
        inds=order[sel],
        valid=valid,
    )

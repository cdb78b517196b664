"""MaxIoU anchor-GT assignment on static shapes.

Semantics of mmdet's ``MaxIoUAssigner.assign_wrt_overlaps``:

1. default: ignore (-1)
2. max_overlap < neg_thr        -> background (0)
3. max_overlap >= pos_thr       -> that gt (i+1)
4. match_low_quality: every gt claims its best anchor(s) if its best overlap
   >= min_pos_iou — later gts overwrite earlier ones (loop order), so the
   last candidate gt wins.

GT boxes arrive padded to a fixed count with a validity mask; padded gts read
as overlap 0. ``cand = overlaps == gt_max`` is an exact float comparison, and
with ``min_pos_iou=0.0`` a valid gt whose best overlap is 0 claims every
anchor it has overlap 0 with: mmdet's behaviour, kept by the JAX package and
kept here.

Over the ranks of a "space" axis (``group``: each rank holds the overlaps of
its own anchors, ``parallel/sharding.py:partition_spatially``) everything is
per anchor but ``gt_max``, each gt's best overlap over *every* anchor: one
all-reduce MAX of the (..., G) maxima over the group, which is exact, so the
ranks' joined result is one process's. Only the rescue that claims every
anchor equal to the maximum (``gt_max_assign_all``) splits so; the argmax
branch (SSD's) raises on a group of several ranks.

Everything works on the last two axes, so one call assigns a whole batch:
``overlaps`` (..., G, N), ``gt_mask`` and ``gt_labels`` (..., G). No size
depends on the data, so nothing here waits for the device. The JAX package
gathers labels through a one-hot product (its ``ops/gather.py:take_rows``, a
TPU idiom); here that is plain indexing on pre-clipped indices, and no
``ops/gather.py`` exists in this package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..parallel.distributed import group_max


class AssignResult(NamedTuple):
    """gt_inds: (..., N) int32, -1 ignore / 0 background / i+1 -> gt i.
    max_overlaps: (..., N) float32. labels: (..., N) int32 (-1 where
    unassigned)."""

    gt_inds: torch.Tensor
    max_overlaps: torch.Tensor
    labels: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MaxIoUAssigner:
    pos_iou_thr: float = 0.5
    neg_iou_thr: float | tuple = 0.4
    min_pos_iou: float = 0.0
    gt_max_assign_all: bool = True
    match_low_quality: bool = True

    def __call__(
        self,
        overlaps: torch.Tensor,      # (..., G, N) gt x anchors
        gt_mask: torch.Tensor,       # (..., G) bool validity of padded gts
        gt_labels: torch.Tensor | None = None,  # (..., G) integer
        group=None,  # the "space" ranks that hold the other anchors
    ) -> AssignResult:
        g = overlaps.shape[-2]
        split = group is not None and dist.get_world_size(group) > 1
        if split and self.match_low_quality and not self.gt_max_assign_all:
            raise ValueError("gt_max_assign_all=False takes each gt's argmax "
                             "anchor, which one rank of a split head cannot "
                             "know; run such a head gathered")
        # Padded gts read as zero overlap, so with no valid gt every anchor
        # falls in [0, neg_thr) -> background. -1 stays reserved for ignore.
        overlaps = torch.where(gt_mask[..., None], overlaps, 0.0)

        # both argmax calls return the first maximum, as jnp.argmax does
        max_overlaps, argmax_overlaps = overlaps.max(dim=-2)     # (..., N)
        gt_max = overlaps.amax(dim=-1)                           # (..., G)
        if split:
            gt_max = group_max(gt_max, group)

        if isinstance(self.neg_iou_thr, tuple):
            neg_lo, neg_hi = self.neg_iou_thr
        else:
            neg_lo, neg_hi = 0.0, self.neg_iou_thr
        assigned = torch.where(
            (max_overlaps >= neg_lo) & (max_overlaps < neg_hi), 0, -1)
        assigned = torch.where(max_overlaps >= self.pos_iou_thr,
                               argmax_overlaps + 1, assigned)

        if self.match_low_quality:
            # cand[i, n]: anchor n is (one of) gt i's best anchors and gt i
            # clears min_pos_iou.
            good_gt = gt_mask & (gt_max >= self.min_pos_iou)
            if self.gt_max_assign_all:
                cand = overlaps == gt_max[..., None]
            else:
                cand = torch.zeros_like(overlaps, dtype=torch.bool).scatter_(
                    -1, overlaps.argmax(dim=-1, keepdim=True), True)
            cand = cand & good_gt[..., None]
            # last gt in loop order wins: the largest candidate index + 1,
            # 0 where no gt claims the anchor
            order = torch.arange(1, g + 1, device=overlaps.device)
            winner = (cand * order[:, None]).amax(dim=-2)        # (..., N)
            assigned = torch.where(winner > 0, winner, assigned)

        assigned = assigned.to(torch.int32)
        if gt_labels is None:
            labels = torch.full_like(assigned, -1)
        else:
            safe_idx = (assigned - 1).clamp(0, g - 1).to(torch.int64)
            picked = gt_labels.to(torch.int32).gather(-1, safe_idx)
            labels = torch.where(assigned > 0, picked, -1)
        return AssignResult(assigned, max_overlaps, labels)

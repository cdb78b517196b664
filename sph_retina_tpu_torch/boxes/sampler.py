"""Positive/negative samplers over assignment results, on fixed shapes.

- ``pseudo_sample`` (RetinaNet, FCOS, SSD): every positive and negative is
  used; returned as boolean masks.
- ``RandomSampler`` (Faster R-CNN): keep at most ``num * pos_fraction``
  positives and fill the rest with negatives. Random priorities are drawn
  from an explicit ``torch.Generator`` and the top ones within each group are
  kept as a mask, so no size depends on the data and nothing waits for the
  device. The JAX package draws its priorities from ``jax.random``: the two
  packages keep the same number of entries of each group, not the same ones.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class SampleResult(NamedTuple):
    pos_mask: torch.Tensor  # (..., N) bool
    neg_mask: torch.Tensor  # (..., N) bool


def pseudo_sample(gt_inds: torch.Tensor) -> SampleResult:
    return SampleResult(gt_inds > 0, gt_inds == 0)


def _keep_topk_random(generator: torch.Generator | None, mask: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Keep at most k True entries of ``mask`` along its last axis,
    uniformly at random."""
    n = mask.shape[-1]
    prio = torch.rand(mask.shape, generator=generator, device=mask.device)
    prio = torch.where(mask, prio, -1.0)
    if k >= n:
        return mask
    # threshold = the k-th largest priority along the axis
    kth = torch.sort(prio, dim=-1).values[..., n - k:n - k + 1]
    count = mask.sum(dim=-1, keepdim=True)
    return torch.where(count <= k, mask, mask & (prio > kth))


@dataclasses.dataclass(frozen=True)
class RandomSampler:
    num: int = 256
    pos_fraction: float = 0.5
    neg_pos_ub: float = -1.0
    add_gt_as_proposals: bool = True  # handled by the RoI head

    def __call__(self, generator: torch.Generator | None,
                 gt_inds: torch.Tensor) -> SampleResult:
        num_pos_max = int(self.num * self.pos_fraction)
        pos = _keep_topk_random(generator, gt_inds > 0, num_pos_max)
        num_neg_max = self.num - num_pos_max  # conservative static budget
        if self.neg_pos_ub > 0:
            num_neg_max = min(num_neg_max, int(self.neg_pos_ub * num_pos_max))
        neg = _keep_topk_random(generator, gt_inds == 0, num_neg_max)
        return SampleResult(pos, neg)

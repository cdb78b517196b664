"""Anchor-shape optimisation on a dataset's ground-truth boxes.

The free parameters are spherical FoV pairs (alpha, beta) in degrees; the
overlap is a spherical IoU backend (``iou.sph_overlaps``, plain PyTorch on
the boxes' device: it does not launch the fused kernel) with both boxes
centred on the equator at (180, 90), where the IoU depends on the FoVs
only. Two optimisers maximise the average best-anchor IoU: k-means under the
IoU (E-step argmax, M-step mean) and differential evolution (rand/1/bin).

Each random draw is separate from the deterministic step it feeds
(``_kmeans_sweeps``, ``_population_fitness``, ``_de_generation``). Every
draw comes from a CPU ``torch.Generator`` seeded with ``seed`` and is then
moved to the device, so that the card and the CPU draw the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..iou import sph_overlaps
from ..utils.device import resolve_device

_CENTER = (180.0, 90.0)  # the equator: a centred pair's IoU is its FoVs'


def centered_boxes(fovs) -> torch.Tensor:
    """(K, 2) (alpha, beta) FoVs -> (K, 4) float32 BFoV boxes centred on
    the equator, on the FoVs' device."""
    fovs = torch.as_tensor(fovs, dtype=torch.float32)
    center = torch.tensor(_CENTER, dtype=torch.float32,
                          device=fovs.device).expand(*fovs.shape[:-1], 2)
    return torch.cat([center, fovs], dim=-1)


def mean_best_iou(gt_fovs, anchor_fovs, backend: str = "sph2pob_efficient",
                  device=None) -> float:
    """Average best-anchor IoU over the dataset: the objective both
    optimisers maximise. ``device``: ``None`` means the CUDA device."""
    device = resolve_device(device)
    gt = torch.as_tensor(gt_fovs, dtype=torch.float32).to(device)
    anchors = torch.as_tensor(anchor_fovs, dtype=torch.float32).to(device)
    return float(sph_overlaps(centered_boxes(gt), centered_boxes(anchors),
                              backend).amax(dim=1).mean())


def _sorted_by_area(fovs: torch.Tensor) -> np.ndarray:
    out = fovs.cpu().numpy()
    return out[np.argsort(out.prod(axis=1))]


def _kmeans_sweeps(gt: torch.Tensor, centers: torch.Tensor, iters: int,
                   backend: str) -> torch.Tensor:
    """``iters`` E/M sweeps from ``centers``: each GT joins its argmax-IoU
    centre (the first among equals), each centre moves to its members'
    mean; an empty cluster keeps its centre."""
    k = centers.shape[0]
    for _ in range(iters):
        assign = sph_overlaps(centered_boxes(gt), centered_boxes(centers),
                              backend).argmax(dim=1)
        count = torch.zeros(k, dtype=gt.dtype, device=gt.device).index_add_(
            0, assign, torch.ones_like(gt[:, 0]))
        sums = torch.zeros_like(centers).index_add_(0, assign, gt)
        centers = torch.where(count[:, None] > 0,
                              sums / count.clamp_min(1.0)[:, None], centers)
    return centers


def kmeans_anchors(gt_fovs, num_anchors: int, iters: int = 25, seed: int = 0,
                   backend: str = "sph2pob_efficient",
                   device=None) -> np.ndarray:
    """IoU-distance k-means over (alpha, beta) FoVs from ``num_anchors``
    distinct GTs drawn by ``seed``; ``iters`` fixed sweeps (converged
    assignments make further sweeps no-ops). Returns (K, 2) sorted by FoV
    product."""
    device = resolve_device(device)
    gt = torch.as_tensor(gt_fovs, dtype=torch.float32).to(device)
    n = gt.shape[0]
    if n < num_anchors:
        raise ValueError(f"{n} GT boxes < {num_anchors} anchors")
    init_idx = torch.randperm(n, generator=torch.Generator().manual_seed(
        seed))[:num_anchors].to(device)
    return _sorted_by_area(_kmeans_sweeps(gt, gt[init_idx], iters, backend))


def _population_fitness(gt: torch.Tensor, pop: torch.Tensor,
                        num_anchors: int, backend: str) -> torch.Tensor:
    """(P, 2K) individuals -> (P,) mean best IoU of each: one (N, P*K) IoU
    matrix for the whole population."""
    iou = sph_overlaps(centered_boxes(gt), centered_boxes(pop.reshape(-1, 2)),
                       backend)
    per = iou.reshape(gt.shape[0], -1, num_anchors)     # (N, P, K)
    return per.amax(dim=2).mean(dim=0)


def _de_draws(generator: torch.Generator, pop_size: int, dim: int,
              crossover: float):
    """One generation's draws: donors (P, 3), three distinct indices none
    the row's own (a permutation of 0..P-2 a row, its first three shifted
    past the row's index); the crossover mask (P, dim); the coordinate
    each individual takes from its mutant whatever the mask (P,)."""
    perm = torch.rand(pop_size, pop_size - 1,
                      generator=generator).argsort(dim=1)[:, :3]
    donors = perm + (perm >= torch.arange(pop_size)[:, None]).long()
    cross = torch.rand(pop_size, dim, generator=generator) < crossover
    forced = torch.randint(0, dim, (pop_size,), generator=generator)
    return donors, cross, forced


def _de_generation(gt, pop, fit, donors, cross, forced, *, mutation: float,
                   bounds: tuple, num_anchors: int, backend: str):
    """One rand/1/bin generation from its draws: mutant a + F (b - c)
    clipped to ``bounds``, trial coordinates from the mutant where the mask
    or the forced coordinate says, a trial replacing its target where its
    fitness is strictly higher. Returns the new (pop, fit)."""
    a, b, c = pop[donors[:, 0]], pop[donors[:, 1]], pop[donors[:, 2]]
    mutant = (a + mutation * (b - c)).clamp(*bounds)
    take = cross | torch.nn.functional.one_hot(forced, pop.shape[1]).bool()
    trial = torch.where(take, mutant, pop)
    tfit = _population_fitness(gt, trial, num_anchors, backend)
    better = tfit > fit
    return (torch.where(better[:, None], trial, pop),
            torch.where(better, tfit, fit))


def evolve_anchors(gt_fovs, num_anchors: int, iters: int = 200,
                   pop_size: int = 48, seed: int = 0,
                   bounds: tuple = (1.0, 179.0), mutation: float = 0.5,
                   crossover: float = 0.9, backend: str = "sph2pob_efficient",
                   device=None) -> np.ndarray:
    """Differential evolution (rand/1/bin) over K (alpha, beta) pairs: a
    population of ``pop_size`` drawn uniformly in ``bounds``, ``iters``
    generations; returns the fittest individual's (K, 2) sorted by FoV
    product."""
    device = resolve_device(device)
    gt = torch.as_tensor(gt_fovs, dtype=torch.float32).to(device)
    dim = num_anchors * 2
    lo, hi = bounds
    generator = torch.Generator().manual_seed(seed)
    pop = (lo + (hi - lo) * torch.rand(pop_size, dim,
                                       generator=generator)).to(device)
    fit = _population_fitness(gt, pop, num_anchors, backend)
    for _ in range(iters):
        donors, cross, forced = (t.to(device) for t in _de_draws(
            generator, pop_size, dim, crossover))
        pop, fit = _de_generation(gt, pop, fit, donors, cross, forced,
                                  mutation=mutation, bounds=bounds,
                                  num_anchors=num_anchors, backend=backend)
    return _sorted_by_area(pop[fit.argmax()].reshape(num_anchors, 2))

"""The general traffic generator: turns a mix file (``traffic/<mix>.json``)
and a configuration into the inputs of one run, from ``--seed``.

A mix states its ``kind`` (``train``: batches of images with padded
ground-truth boxes, on the device; ``detect``: batches of frames on the
host), the batch, a pool of distinct batches cycled through by the run,
the ground-truth count distribution and the box generator's ranges.

Every seed gets the same multiset of ground-truth counts (log-uniform
quantiles over [min, max], as many as the pool has images) in another
order, so that seeds change the data and not the amount of work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .boxes import generate_boxes


def gt_counts(mix: dict, n_images: int, rng: np.random.Generator) -> np.ndarray:
    """Ground-truth boxes an image: log-uniform quantiles, seeded order."""
    g = mix["gt_per_image"]
    lo, hi = g["min"], g["max"]
    u = (np.arange(n_images) + 0.5) / n_images
    counts = np.floor(np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo))))
    return rng.permutation(np.clip(counts, lo, hi).astype(np.int64))


def train_pool(config: dict, mix: dict, seed: int, device) -> list[dict]:
    """``mix['pool']`` distinct batches: uint8 images made on the device by
    a seeded generator in one call, and padded ground truth (padding boxes
    all 1.0, labels 0, mask False, as the port's pipeline pads)."""
    b, pool = mix["batch"], mix["pool"]
    h, w = config["img_size"]
    d, g_max = config["box_version"], config["max_gt"]
    rng = np.random.default_rng([seed, 1])
    counts = gt_counts(mix, b * pool, rng)
    r = mix["boxes"]
    boxes = generate_boxes(int(counts.sum()), d, seed=[seed, 2],
                           theta_range=r["theta"], phi_range=r["phi"],
                           fov_range=r["fov"], gamma_range=r["gamma"])
    labels = rng.integers(0, config["num_classes"], int(counts.sum()))
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randint(0, 256, (pool, b, h, w, 3), generator=gen,
                           dtype=torch.uint8, device=device)
    gt_boxes = np.ones((pool * b, g_max, d), np.float32)
    gt_labels = np.zeros((pool * b, g_max), np.int32)
    gt_mask = np.zeros((pool * b, g_max), bool)
    start = 0
    for i, n in enumerate(counts):
        gt_boxes[i, :n] = boxes[start:start + n]
        gt_labels[i, :n] = labels[start:start + n]
        gt_mask[i, :n] = True
        start += n

    def to(x):
        return torch.from_numpy(x).to(device)

    return [{"images": images[p],
             "gt_boxes": to(gt_boxes[p * b:(p + 1) * b]),
             "gt_labels": to(gt_labels[p * b:(p + 1) * b]),
             "gt_mask": to(gt_mask[p * b:(p + 1) * b])} for p in range(pool)]


def detect_pool(config: dict, mix: dict, seed: int) -> list[list[np.ndarray]]:
    """``mix['pool']`` batches of ``mix['batch']`` uint8 frames (H, W, 3)
    made on the host from the seed."""
    b, pool = mix["batch"], mix["pool"]
    h, w = config["img_size"]
    rng = np.random.default_rng([seed, 3])
    raw = np.frombuffer(rng.bytes(pool * b * h * w * 3), np.uint8)
    frames = raw.reshape(pool, b, h, w, 3)
    return [[frames[p, i] for i in range(b)] for p in range(pool)]

"""Batching + background prefetch, and a synthetic dataset for tests.

A thread-pool prefetcher: pipeline work is PIL/numpy (which release the
interpreter lock), batches are stacked on the host as numpy arrays;
``prefetch_to_device`` turns them into tensors on the device one batch ahead
of the step. Indices and per-sample random streams are drawn exactly as the
JAX package's loader draws them, so both yield identical batches from the
same dataset and seed.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import generate_boxes
from .pipeline import SphPipeline


@dataclass
class DataLoader:
    dataset: object
    pipeline: SphPipeline
    batch_size: int = 8
    shuffle: bool = True
    seed: int = 0
    num_workers: int = 4
    drop_last: bool = True
    prefetch: int = 2
    # Per-process dataset shards belong to multi-process data parallelism,
    # which is not part of this package yet.
    num_shards: int = 1
    shard_id: int = 0
    # Augmentation-stream seed; defaults to ``seed``. Only the per-sample
    # augmentation rngs use it, never the shuffle.
    aug_seed: int | None = None

    def __post_init__(self):
        if self.num_shards != 1 or self.shard_id != 0:
            raise NotImplementedError(
                f"num_shards={self.num_shards}, shard_id={self.shard_id}: "
                "dataset shards are not available in this package yet")

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[: len(self) * self.batch_size]
        return idx

    def epoch(self, epoch: int = 0):
        """Yield stacked numpy batches with background prefetch."""
        indices = self._epoch_indices(epoch)
        batches = indices.reshape(-1, self.batch_size) if self.drop_last else [
            indices[i:i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def produce():
            # num_workers=0 means "no parallelism", not "no pool"
            with ThreadPoolExecutor(max(1, self.num_workers)) as pool:
                for bi, batch_idx in enumerate(batches):
                    aug = self.seed if self.aug_seed is None else self.aug_seed
                    rngs = [
                        np.random.default_rng((aug, epoch, bi, int(i)))
                        for i in batch_idx
                    ]
                    samples = list(pool.map(
                        lambda a: self.pipeline(self.dataset[int(a[0])], a[1]),
                        zip(batch_idx, rngs),
                    ))
                    q.put({k: np.stack([s[k] for s in samples])
                           for k in samples[0]})

        def run():
            # A producer crash (decode error, bad path) must surface in the
            # consumer, not leave it blocked on a queue that never closes.
            try:
                produce()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)
            else:
                q.put(stop)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def to_device(batch: dict, device: torch.device) -> dict:
    """A numpy batch as tensors on ``device``. For the card the arrays go
    through pinned host memory and the copies are asynchronous
    (``non_blocking``), on the current stream."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(iterator, transfer, depth: int = 1):
    """Keep ``depth`` transferred batches ahead of the consumer.

    ``transfer`` maps a host batch to tensors on the device (``to_device``).
    Its copies are asynchronous, so the host has enqueued batch k+1's copy
    before the consumer's step on batch k returns; on the device they run in
    stream order, between two steps.
    """
    ahead = collections.deque()
    for batch in iterator:
        ahead.append(transfer(batch))
        if len(ahead) > depth:
            yield ahead.popleft()
    while ahead:
        yield ahead.popleft()


def make_synthetic_dataset(
    n_images: int = 8,
    num_classes: int = 7,
    img_size=(64, 128),
    box_version: int = 4,
    max_boxes: int = 6,
    seed: int = 0,
):
    """In-memory synthetic spherical dataset: seeded noise images with 1 to
    ``max_boxes`` random boxes each."""
    h, w = img_size

    class _Synthetic:
        classes = tuple(f"class_{i}" for i in range(num_classes))
        num_classes_ = num_classes

        def __len__(self):
            return n_images

        def __getitem__(self, idx):
            r = np.random.default_rng((seed, idx))
            n = int(r.integers(1, max_boxes + 1))
            boxes = generate_boxes(n, box_version, seed=seed * 1000 + idx,
                                   fov_range=(10.0, 60.0))
            return {
                "img_id": idx,
                "image": (r.random((h, w, 3)) * 255).astype(np.uint8),
                "boxes": boxes,
                "labels": r.integers(0, num_classes, n).astype(np.int32),
            }

    return _Synthetic()

"""Batching + background prefetch, and a synthetic dataset for tests.

A thread-pool prefetcher: pipeline work is the native decoder, PIL or numpy
(all of which release the interpreter lock for their long calls), batches
are stacked on the host as numpy arrays; ``prefetch_to_device`` turns them
into tensors on the device two batches ahead of the step, on a thread of its
own and, on the card, on a CUDA stream of its own (``to_device`` through
``PinnedStaging``). Indices and per-sample random streams are drawn exactly
as the JAX package's loader draws them, so both yield identical batches from
the same dataset and seed.
"""

from __future__ import annotations

import contextlib
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


class PinnedStaging:
    """Pinned host buffers, reused round-robin, through which a batch is
    copied to the card.

    A batch's arrays are copied into a slot's page-locked tensors (the copy
    releases the interpreter lock), then to the device with ``non_blocking``
    copies on the current stream, after which an event is recorded; before a
    slot is written again its event is waited for, so a copy still in flight
    never reads overwritten memory. A slot's tensors are allocated once, and
    again only when a batch's shapes change (the last, partial batch)."""

    def __init__(self, slots: int = 2):
        self._slots = [{} for _ in range(slots)]
        self._events = [None] * slots
        self._next = 0

    def __call__(self, batch: dict, device: torch.device) -> dict:
        i = self._next
        self._next = (i + 1) % len(self._slots)
        if self._events[i] is not None:
            self._events[i].synchronize()
        slot, out = self._slots[i], {}
        for k, v in batch.items():
            src = torch.from_numpy(np.ascontiguousarray(v))
            buf = slot.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = slot[k] = torch.empty(src.shape, dtype=src.dtype,
                                            pin_memory=True)
            buf.copy_(src)
            out[k] = buf.to(device, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record()
        return out


def to_device(batch: dict, device, staging: PinnedStaging | None = None
              ) -> dict:
    """A numpy batch as tensors on ``device``. For the card the arrays go
    through pinned host memory (``staging``'s reused buffers, else buffers
    pinned for this call) and the copies are asynchronous (``non_blocking``)
    on the current stream: under ``prefetch_to_device``, its copy stream."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}
    return (staging or PinnedStaging(slots=1))(batch, device)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def prefetch_to_device(iterator, transfer, depth: int = 2, device=None):
    """Overlap host->device transfer with device compute.

    ``transfer`` maps a host batch to tensors on the device (``to_device``).
    Transfers run on a background thread, ``depth`` batches ahead of the
    consumer, in order; an exception of the producer or of a transfer is
    raised in the consumer after the batches before it. With a CUDA
    ``device`` the transfers run on a dedicated ``torch.cuda.Stream``: an
    event is recorded after each batch's copies, the consumer's current
    stream waits on it before the batch is yielded, and every tensor of the
    batch is ``record_stream``-ed on that stream, so the caching allocator
    cannot hand its memory out while the consumer's kernels still read it.
    Without a CUDA device no stream is created.
    """
    device = None if device is None else torch.device(device)
    stream = torch.cuda.Stream(device) if device is not None \
        and device.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    closed = threading.Event()

    def put(item) -> bool:
        # gives up once the consumer is gone, so the thread never blocks on
        # a queue nobody reads
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            with torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext():
                for batch in iterator:
                    out = transfer(batch)
                    ready = None
                    if stream is not None:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    if not put((out, ready)):
                        return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            put(e)
        else:
            put(stop)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            out, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for v in _tensors(out):
                    if v.is_cuda:
                        v.record_stream(current)
            yield out
    finally:
        closed.set()


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

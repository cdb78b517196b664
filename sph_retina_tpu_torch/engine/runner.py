"""Epoch-based training runner: loop, checkpoints, periodic eval, logging.

Semantics of mmcv's EpochBasedRunner as the configs drive it: per-epoch
iteration, CheckpointHook interval, periodic evaluation with best-metric
tracking (``save_best='AP50'``), TextLogger-style metric lines at
``log_config.interval``, an epoch record after each epoch, the memory report
at a MemoryProfiler interval. A checkpoint is one ``torch.save`` file: the
model's ``state_dict``, the optimiser's state, the step count and the state
of the train step's generator.
"""

from __future__ import annotations

import json
import os
import resource
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.loader import prefetch_to_device


@dataclass
class MetricLogger:
    """JSONL metric sink, plus TensorBoard and wandb where they can be
    imported (``wandb`` is opt-in through ``wandb_init`` kwargs)."""

    log_dir: str
    interval: int = 10
    enabled: bool = True  # False: log() writes nothing
    wandb_init: dict | None = None  # e.g. {"project": "sph", "name": "run1"}
    _file: object = field(default=None, repr=False)
    _tb: object = field(default=None, repr=False)
    _wandb: object = field(default=None, repr=False)

    def __post_init__(self):
        if not self.enabled:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        self._file = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(os.path.join(self.log_dir, "tb"))
        if self.wandb_init is not None:
            try:
                import wandb
            except ImportError:
                self._wandb = None
            else:
                self._wandb = wandb.init(dir=self.log_dir, **self.wandb_init)

    def log(self, step: int, metrics: dict, prefix: str = "train"):
        """Write one record. ``float(v)`` of a tensor on the card waits for
        it: this is the training loop's only read-back."""
        if not self.enabled:
            return
        values = {k: float(v) for k, v in metrics.items()}
        record = {"step": step, "prefix": prefix, **values,
                  "time": time.time()}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)
        if self._wandb is not None:
            self._wandb.log({f"{prefix}/{k}": v for k, v in values.items()},
                            step=step)

    def close(self):
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def memory_report() -> dict:
    """Host and device memory snapshot (mmdet's MemoryProfilerHook: available
    and total host memory and the process's peak RSS, without psutil; plus,
    for each local CUDA device, the memory allocated now and at its peak)."""
    stats = {}
    try:
        with open("/proc/meminfo") as f:
            mem = {line.split(":")[0]: int(line.split()[1])
                   for line in f if ":" in line}
        stats["host_available_mb"] = mem.get("MemAvailable", 0) // 1024
        stats["host_total_mb"] = mem.get("MemTotal", 0) // 1024
    except OSError:
        pass
    stats["process_rss_mb"] = (
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024)
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats[f"device{i}_in_use_mb"] = torch.cuda.memory_allocated(i) >> 20
            stats[f"device{i}_peak_mb"] = \
                torch.cuda.max_memory_allocated(i) >> 20
    return stats


CHECKPOINT_FORMAT = 1


def _epoch_of(name: str) -> int | None:
    """N of a complete checkpoint file ``epoch_N``; None for anything else
    (a temporary ``epoch_N.tmp`` included)."""
    if not name.startswith("epoch_"):
        return None
    try:
        return int(name[len("epoch_"):])
    except ValueError:
        return None


def _write_atomically(path: str, write) -> None:
    """``write(tmp_path)``, then rename over ``path``: a reader sees the old
    file or the whole new one, never a part."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


class Checkpointer:
    """Interval saves, best-metric tracking and resume, one ``torch.save``
    file a checkpoint under ``<ckpt_dir>/epoch_N`` (and ``best``), with
    ``latest.txt`` naming the newest."""

    def __init__(self, ckpt_dir: str, save_best: str | None = "AP50"):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.save_best = save_best
        self.best = -np.inf

    def save(self, model, optimizer, epoch: int, metric: float | None = None,
             generator: torch.Generator | None = None) -> str:
        """Write ``epoch_{epoch}``; only once it is complete on disk is
        ``latest.txt`` advanced, so that a crash in between leaves the
        pointer at the previous checkpoint. Returns the path."""
        ckpt = {
            "format": CHECKPOINT_FORMAT,
            "step": optimizer.count,
            "epoch": epoch,
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "generator": None if generator is None else generator.get_state(),
        }
        path = os.path.join(self.dir, f"epoch_{epoch}")
        _write_atomically(path, lambda tmp: torch.save(ckpt, tmp))

        def write_pointer(tmp):
            with open(tmp, "w") as f:
                f.write(f"epoch_{epoch}")

        _write_atomically(os.path.join(self.dir, "latest.txt"), write_pointer)
        if metric is not None and self.save_best and metric > self.best:
            self.best = metric
            _write_atomically(os.path.join(self.dir, "best"),
                              lambda tmp: torch.save(ckpt, tmp))
        return path

    def latest_path(self) -> str | None:
        """The checkpoint ``latest.txt`` names; where that one is dangling
        or missing (a crash between the checkpoint and the pointer, a
        hand-edited file), the newest complete ``epoch_N`` on disk; None
        when there is none."""
        latest = os.path.join(self.dir, "latest.txt")
        if os.path.exists(latest):
            with open(latest) as f:
                candidate = os.path.join(self.dir, f.read().strip())
            if os.path.isfile(candidate):
                return candidate
        epochs = [(n, name) for name in os.listdir(self.dir)
                  if (n := _epoch_of(name)) is not None
                  and os.path.isfile(os.path.join(self.dir, name))]
        if not epochs:
            return None
        return os.path.join(self.dir, max(epochs)[1])

    def restore(self, model, optimizer, path: str | None = None,
                generator: torch.Generator | None = None) -> int:
        """Load ``path`` (default: :meth:`latest_path`) into the model, the
        optimiser and, where given, the generator; returns the checkpoint's
        step count (the optimiser's count, unchanged, when there is no
        checkpoint)."""
        path = path or self.latest_path()
        if path is None:
            return optimizer.count
        return load_checkpoint(path, model, optimizer, generator)

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending when ``save`` returns."""


def resolve_checkpoint(path: str) -> str:
    """A checkpoint directory (its :meth:`Checkpointer.latest_path`) or one
    checkpoint file -> the file."""
    if os.path.isdir(path):
        found = Checkpointer(path).latest_path()
        if found is None:
            raise FileNotFoundError(f"no checkpoint in {path!r}")
        return found
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    return path


def read_checkpoint(path: str) -> dict:
    """The checkpoint dict of a file written by :class:`Checkpointer`, its
    tensors on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path!r} is not a checkpoint of this package "
                         f"(format {CHECKPOINT_FORMAT})")
    return ckpt


def load_checkpoint(path: str, model, optimizer=None,
                    generator: torch.Generator | None = None) -> int:
    """Load a checkpoint file (or the newest of a directory) into the live
    tensors of the model, the optimiser and the generator; returns its
    step count."""
    ckpt = read_checkpoint(resolve_checkpoint(path))
    model.load_state_dict(ckpt["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    if generator is not None:
        if ckpt["generator"] is None:
            raise ValueError(f"{path!r} holds no generator state")
        generator.set_state(ckpt["generator"])
    return int(ckpt["step"])


def run_training(
    *,
    train_step,
    optimizer,
    loader,
    max_epochs: int,
    logger: MetricLogger,
    checkpointer: Checkpointer | None = None,
    ckpt_interval: int = 25,
    eval_fn=None,
    eval_interval: int = 5,
    transfer=lambda b: b,
    memory_interval: int | None = None,
    model=None,
    device=None,
):
    """The main loop. ``train_step(batch) -> metrics`` updates the model in
    place; ``transfer`` maps a host batch of the loader to tensors on the
    model's device, two batches ahead of the step, on a copy stream of its
    own where ``device`` is a CUDA device (``prefetch_to_device``).
    ``eval_fn() -> dict`` runs after every epoch where
    ``(epoch + 1) % eval_interval == 0`` (logged with prefix ``val``, its
    ``AP50`` passed to the checkpointer), and ``checkpointer`` saves
    ``model`` every ``ckpt_interval`` epochs and after the last one, with
    ``train_step.generator`` where the step has one. Returns the number of
    steps taken so far (``optimizer.count``)."""
    if checkpointer is not None and model is None:
        raise ValueError("a checkpointer needs the model")
    step_count = optimizer.count
    # Start at the epoch the step count implies rather than at epoch 0.
    steps_per_epoch = max(1, len(loader)) if hasattr(loader, "__len__") else None
    start_epoch = min(step_count // steps_per_epoch, max_epochs) \
        if steps_per_epoch else 0

    for epoch in range(start_epoch, max_epochs):
        t_epoch = time.time()
        for batch in prefetch_to_device(loader.epoch(epoch), transfer,
                                        device=device):
            metrics = train_step(batch)
            step_count += 1
            if step_count % logger.interval == 0:
                # NaN-loss detection (mmdet's CheckLossHook)
                loss_val = float(metrics.get("loss", 0.0))
                if loss_val != loss_val:
                    logger.log(step_count, {"nan_loss": 1.0}, prefix="error")
                    raise FloatingPointError(
                        f"loss is NaN at step {step_count}")
                logger.log(step_count, metrics)
            if memory_interval and step_count % memory_interval == 0:
                logger.log(step_count, memory_report(), prefix="memory")
        epoch_time = time.time() - t_epoch
        logger.log(step_count, {"epoch": epoch, "epoch_time": epoch_time},
                   prefix="epoch")

        metric = None
        if eval_fn is not None and (epoch + 1) % eval_interval == 0:
            results = eval_fn()
            logger.log(step_count, results, prefix="val")
            metric = results.get("AP50")
        if checkpointer is not None and (
            (epoch + 1) % ckpt_interval == 0 or epoch + 1 == max_epochs
        ):
            checkpointer.save(model, optimizer, epoch + 1, metric,
                              getattr(train_step, "generator", None))
    if checkpointer is not None:
        checkpointer.wait()
    return step_count

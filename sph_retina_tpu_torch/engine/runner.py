"""Epoch-based training runner: loop, periodic logging, NaN-loss check.

Semantics of mmcv's EpochBasedRunner as the configs drive it: per-epoch
iteration, TextLogger-style metric lines at ``log_config.interval``, an epoch
record after each epoch. Checkpoints, periodic evaluation and the memory
report are not part of this package yet: the loop takes
``checkpointer=None, eval_fn=None`` and raises for anything else.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

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


def run_training(
    *,
    train_step,
    optimizer,
    loader,
    max_epochs: int,
    logger: MetricLogger,
    checkpointer=None,
    eval_fn=None,
    transfer=lambda b: b,
):
    """The main loop. ``train_step(batch) -> metrics`` updates the model in
    place; ``transfer`` maps a host batch of the loader to tensors on the
    model's device. Returns the number of steps taken so far
    (``optimizer.count``)."""
    if checkpointer is not None:
        raise NotImplementedError(
            "checkpointer: checkpoints are not available in this package yet")
    if eval_fn is not None:
        raise NotImplementedError(
            "eval_fn: evaluation is not available in this package yet")
    step_count = optimizer.count
    # Start at the epoch the step count implies rather than at epoch 0.
    steps_per_epoch = max(1, len(loader)) if hasattr(loader, "__len__") else None
    start_epoch = min(step_count // steps_per_epoch, max_epochs) \
        if steps_per_epoch else 0

    for epoch in range(start_epoch, max_epochs):
        t_epoch = time.time()
        for batch in prefetch_to_device(loader.epoch(epoch), transfer):
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
        epoch_time = time.time() - t_epoch
        logger.log(step_count, {"epoch": epoch, "epoch_time": epoch_time},
                   prefix="epoch")
    return step_count

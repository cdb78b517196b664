"""Training runtime: LR schedule, optimiser, train step.

Semantics of the schedule configs: SGD momentum 0.9, weight decay 5e-4, step
LR with linear warm-up, optional gradient clipping, frozen backbone stages,
optional EMA of the parameters. The optimiser is written out, not taken from
``torch.optim``, because it has to equal the JAX package's optax chain
``clip_by_global_norm -> add_decayed_weights -> trace(momentum) -> * -lr``
where ``torch.optim`` and ``torch.nn.utils.clip_grad_norm_`` differ from it
(the clip there divides by ``norm + 1e-6``; here a gradient below the limit
is left bit for bit as it is).

Execution model: eager PyTorch, parameters updated in place. A step does not
wait for the device: the learning rate comes from a count kept on the host,
the gradient norm and every loss stay 0-dim tensors on the device, and the
only read-back is the logger's.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from ..data.pipeline import maybe_normalize_images
from ..parallel import all_reduce_gradients, loss_replicas
from ..parallel.sharding import full_tensors, global_norm, local_shards


def step_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    milestones=(80, 110),
    gamma: float = 0.1,
    warmup_iters: int = 500,
    warmup_ratio: float = 0.001,
) -> Callable[[int], float]:
    """Linear warm-up + epoch-milestone decay: ``schedule(count) -> lr``.

    ``count`` is the number of steps already taken, so the first step runs at
    ``base_lr * warmup_ratio``; the decay applies from ``count == milestone *
    steps_per_epoch`` on. Computed in float32, operation for operation as the
    JAX package's schedule, so that both give the same number.
    """
    f32 = np.float32
    boundaries = sorted(m * steps_per_epoch for m in milestones)

    def schedule(count: int) -> float:
        count = int(count)
        if count < warmup_iters:
            ramp = f32(1.0 - warmup_ratio) * f32(min(count, warmup_iters)) \
                / f32(warmup_iters)
            return float(f32(base_lr) * (f32(warmup_ratio) + ramp))
        lr = f32(base_lr)
        for boundary in boundaries:
            if count >= boundary:
                lr = f32(gamma) * lr
        return float(lr)

    return schedule


def _is_frozen(name: str, frozen_prefixes: Iterable[str]) -> bool:
    """``name`` is a module path with dots; the prefixes are spelled with
    slashes, as the configs and the JAX package spell them. A plain
    ``startswith``: ``backbone/layer1`` freezes ``layer1_0``, ``layer1_1``,
    ... (and would freeze a ``layer10``)."""
    path = name.replace(".", "/")
    return any(path.startswith(p) for p in frozen_prefixes)


class SGDOptimizer:
    """SGD + momentum + weight decay with optional global-norm clip, frozen
    parameter subtrees and an EMA of the parameters.

    One ``step()`` reads ``p.grad`` of every trainable parameter and does, in
    this order: clip by the global norm of the trainable gradients (``g *
    max_norm / norm`` only where ``norm >= max_norm``), ``g += wd * p`` on
    every trainable tensor (norms and biases included), ``buf = momentum *
    buf + g``, ``p -= lr * buf`` with ``lr = schedule(count)`` read before the
    count advances. Parameters under ``frozen_prefixes`` get
    ``requires_grad_(False)`` at construction and are never touched. With
    ``ema_momentum`` the shadow parameters follow the post-update values by
    the mmcv convention ``ema += m * (p - ema)``, frozen ones included.

    Under ``parallel.sharding.shard_state_fsdp`` a sharded parameter, its
    gradient, its momentum buffer and its EMA shadow are this rank's slices:
    the update is elementwise, the clip's norm is that of the whole gradient
    (``global_norm``), and ``state_dict`` gathers whole tensors.
    """

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 grad_clip: float | None = None,
                 frozen_prefixes: tuple = (),
                 ema_momentum: float | None = None):
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.ema_momentum = ema_momentum
        self.count = 0
        self.names, self.params, self.frozen_names = [], [], []
        for name, p in model.named_parameters():
            if _is_frozen(name, frozen_prefixes):
                p.requires_grad_(False)
                self.frozen_names.append(name)
            else:
                p.requires_grad_(True)
                self.names.append(name)
                self.params.append(p)
        self.bufs = [torch.zeros_like(p) for p in self.params]
        self._all_params = [p for _, p in model.named_parameters()]
        self._all_names = [n for n, _ in model.named_parameters()]
        self.ema = None
        if ema_momentum is not None:
            self.ema = [p.detach().clone() for p in self._all_params]
        self.last_lr = None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        missing = [n for n, p in zip(self.names, self.params) if p.grad is None]
        if missing:
            raise RuntimeError(
                f"{len(missing)} trainable parameters have no gradient, "
                f"e.g. {missing[:3]}")
        grads = [p.grad for p in self.params]
        lr = self.last_lr = self.schedule(self.count)
        if self.grad_clip is not None:
            norm = global_norm(self.params, grads)
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        torch._foreach_add_(grads, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(self.bufs, self.momentum)
        torch._foreach_add_(self.bufs, grads)
        torch._foreach_add_(self.params, self.bufs, alpha=-lr)
        if self.ema is not None:
            torch._foreach_lerp_(self.ema, self._all_params, self.ema_momentum)
        self.count += 1

    def ema_state_dict(self) -> dict | None:
        """The EMA shadow of every parameter by name, or None."""
        if self.ema is None:
            return None
        return dict(zip(self._all_names, self.ema))

    def state_dict(self) -> dict:
        """The step count, the momentum buffers and the EMA shadow by
        parameter name, whole (the tensors themselves, not copies, where a
        parameter is not sharded; gathered ones where it is)."""
        return {"count": self.count,
                "momentum_buffers": dict(zip(self.names, full_tensors(
                    self.bufs, self.params))),
                "ema": None if self.ema is None else dict(zip(
                    self._all_names, full_tensors(self.ema,
                                                  self._all_params)))}

    @torch.no_grad()
    def reshard(self, model: nn.Module) -> None:
        """Re-read the parameters by name, after ``parallel.sharding.
        shard_state_fsdp`` replaced sharded ones by their slices, and cut
        each momentum buffer and EMA shadow that is still whole to its
        parameter's slice."""
        params = dict(model.named_parameters())
        self.params = [params[n] for n in self.names]
        self._all_params = [params[n] for n in self._all_names]
        self.bufs = local_shards(self.bufs, self.params)
        if self.ema is not None:
            self.ema = local_shards(self.ema, self._all_params)

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict()`` into this optimiser's tensors. The names
        must be the same, and EMA on in both or in neither."""
        bufs = state["momentum_buffers"]
        if list(bufs) != self.names:
            raise KeyError(
                "momentum buffers do not fit the model: missing "
                f"{sorted(set(self.names) - set(bufs))[:8]}, unexpected "
                f"{sorted(set(bufs) - set(self.names))[:8]}")
        ema = state["ema"]
        if (ema is None) != (self.ema is None):
            raise ValueError(
                f"the state {'has no' if ema is None else 'has an'} EMA "
                f"shadow, the optimiser {'has' if ema is None else 'has none'}")
        if ema is not None and list(ema) != self._all_names:
            raise KeyError("the EMA shadow does not fit the model")
        torch._foreach_copy_(self.bufs, local_shards(
            [bufs[n] for n in self.names], self.params))
        if ema is not None:
            torch._foreach_copy_(self.ema, local_shards(
                [ema[n] for n in self._all_names], self._all_params))
        self.count = int(state["count"])


def get_ema_params(optimizer: SGDOptimizer) -> dict | None:
    """The EMA shadow parameters by name, or None."""
    return optimizer.ema_state_dict()


@torch.no_grad()
def with_ema_params(model: nn.Module, optimizer: SGDOptimizer) -> nn.Module:
    """Copy the EMA shadow into ``model``'s parameters, cast to each one's
    dtype (evaluation with averaged weights, as mmcv's EMAHook does), and
    return the model. Batch-norm statistics are left as they are; without an
    EMA the model is returned unchanged."""
    ema = get_ema_params(optimizer)
    if ema is None:
        return model
    for name, p in model.named_parameters():
        p.copy_(ema[name].to(p.dtype))
    return model


def build_optimizer(
    model: nn.Module,
    schedule: Callable[[int], float],
    momentum: float = 0.9,
    weight_decay: float = 5e-4,
    grad_clip: float | None = None,
    frozen_prefixes: tuple = (),
    ema_momentum: float | None = None,
) -> SGDOptimizer:
    """SGD+momentum+wd with optional clip, frozen subtrees (path prefixes
    such as ``('backbone/conv1', 'backbone/layer1')``: the configs'
    ``frozen_stages=1``) and EMA (retrieve with ``ema_state_dict()``)."""
    return SGDOptimizer(model, schedule, momentum, weight_decay, grad_clip,
                        tuple(frozen_prefixes), ema_momentum)


def total_loss(losses: dict):
    """Sum a detector loss dict into the optimised scalar.

    Keys prefixed ``metric_`` are observability side-channels (e.g.
    ``metric_pos_dropped``): they ride the metrics dict into the logs but
    carry no gradient and must not enter the optimised total.
    """
    return sum(v for k, v in losses.items() if not k.startswith("metric_"))


def run_step(optimizer: SGDOptimizer, compute: Callable[[], tuple]) -> dict:
    """Forward, backward and update: ``compute() -> (total, losses)``.
    Returns the metrics as detached 0-dim tensors (this rank's share: the
    losses are normalised by global counts).

    In a process group the trainable gradients are summed over the ranks
    between the backward pass and the update, so that the optimiser's clip
    sees the global batch's gradient and every rank takes the same step (the
    JAX package's global-batch step). The model is not wrapped in
    ``DistributedDataParallel``: Faster R-CNN's RoI head and OHEM's forward
    run outside ``model(...)``, frozen parameters have no gradient, and the
    module's names stay those a checkpoint of one process has. Where several
    ranks compute the same loss (a head gathered over "space"), each
    backpropagates its share, ``total / loss_replicas()``; where each
    computes its own part of it (a split head), its part whole; parameters
    sharded by
    ``shard_state_fsdp`` had their gradients reduce-scattered in the
    backward pass, and ``all_reduce_gradients`` leaves them out."""
    optimizer.zero_grad()
    total, losses = compute()
    replicas = loss_replicas()
    (total if replicas == 1 else total / replicas).backward()
    all_reduce_gradients(optimizer.params)
    optimizer.step()
    return {"loss": total.detach(),
            **{k: v.detach() for k, v in losses.items()}}


def make_train_step(model: nn.Module, cfg, optimizer: SGDOptimizer,
                    loss_fn: Callable):
    """Build the train step of a single-stage detector.

    ``loss_fn(cfg, cls_scores, bbox_preds, anchors, gt_boxes, gt_labels,
    gt_mask) -> dict`` is the detector's functional loss (``retina_loss``).
    ``train_step(batch) -> metrics`` takes a batch that already lies on the
    model's device and updates the model and the optimiser in place.
    """
    anchors = cfg.flat_anchors(next(model.parameters()).device)

    def train_step(batch: dict) -> dict:
        images = maybe_normalize_images(batch["images"])

        def compute():
            cls_scores, bbox_preds = model(images)
            losses = loss_fn(cfg, cls_scores, bbox_preds, anchors,
                             batch["gt_boxes"], batch["gt_labels"],
                             batch["gt_mask"])
            return total_loss(losses), losses

        return run_step(optimizer, compute)

    return train_step

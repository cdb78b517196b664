"""Process-spanning data parallelism on ``torch.distributed``.

Semantics of the JAX package's ``parallel/distributed.py``: one process per
device, each with the whole model and its own shard of the dataset
(``DataLoader(num_shards=world, shard_id=rank)``), one optimisation step over
the global batch, evaluation results gathered to every process, rank 0 the
only one that writes. Where the JAX package lets XLA insert the gradient
all-reduce into one global-batch program, here each process runs its local
batch eagerly and the pieces that make that equal to the global-batch step
are explicit:

- the parameters start alike (``broadcast_parameters``, from rank 0);
- each count a loss is normalised by is taken over the global batch
  (``global_count``), so that the ranks' losses sum to the global loss;
- the gradients are summed over the ranks after the backward pass
  (``all_reduce_gradients``, in a few flat buckets), before the optimiser
  clips and steps, so every rank takes the same update;
- the logged metrics are summed over the ranks (``global_metrics``).

``init_distributed("torch")`` reads the variables ``torchrun`` sets; the
group is NCCL on the card and gloo on the CPU, and a group that the caller
set up itself is taken as it is. Without a group, or in a group of one
process, every function here leaves its argument as it is (the gradient
all-reduce still runs in a group of one: a sum over one rank). Every wait is
bounded: the group's timeout bounds its collectives, and
``coordination_barrier`` takes its own.

The ranks of a "space" axis (``parallel/sharding.py:partition_spatially``)
share one shard of the batch, which they read by their rank in the *data*
group (``set_data_axis``). Where each of them computes a disjoint part of
the loss (the split heads of RetinaNet and FCOS: each rank its own anchors
or points), the loss normalisers and the logged metrics are summed over
every rank and the loss is not scaled. Where each of them computes the
whole loss of the shard (the gathered heads of SSD and Faster R-CNN), they
are summed over the data group only, each of those ranks scales its loss by
one over their number before the backward pass (``loss_replicas``). The
gradients are summed over every rank in both cases.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                      "LOCAL_RANK")
DEFAULT_TIMEOUT_S = 1800.0
BUCKET_BYTES = 25 << 20  # a flat bucket of the gradient all-reduce


def get_rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


# the group whose rank picks the batch shard, how many ranks compute each
# shard's loss, and the group loss normalisers and metrics sum over (None:
# every rank)
_DATA_AXIS = {"group": None, "replicas": 1, "count_group": None}


def set_data_axis(group=None, replicas: int = 1, count_group=None) -> None:
    """The ranks of ``group`` (None: every rank) read different shards of
    the batch (``get_data_rank``); ``replicas`` ranks compute each shard's
    loss and scale it by ``1 / replicas`` in ``engine/train.py:run_step``
    (a head gathered over "space": each of them the whole loss); loss
    normalisers and metrics sum over ``count_group`` (None: every rank),
    the ranks whose losses are disjoint parts of the batch's. The default,
    ``(None, 1, None)``, is plain data parallelism."""
    _DATA_AXIS.update(group=group, replicas=int(replicas),
                      count_group=count_group)


def loss_replicas() -> int:
    """How many ranks compute each loss (``set_data_axis``)."""
    return _DATA_AXIS["replicas"]


def _count_group_size() -> int:
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(_DATA_AXIS["count_group"])


def get_data_rank() -> int:
    """This process's rank in the data group (``get_rank`` without a
    "space" axis): which shard of the batch it reads."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(_DATA_AXIS["group"])


def init_distributed(launcher: str = "none", backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     device=None) -> tuple[int, int]:
    """Join the process group; returns ``(rank, world_size)``.

    ``launcher="none"``: one process, ``(0, 1)`` (or the rank and size of a
    group that is already initialised). ``launcher="torch"``: the group of
    the processes ``torchrun`` started, from its ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; a missing
    one raises and names it. ``backend`` defaults to ``nccl`` when
    ``device`` is a CUDA device (``None`` counts as one) and ``gloo`` on the
    CPU; on the card, ``cuda:LOCAL_RANK`` becomes the current device. A group
    that is already initialised (by a caller that set one up itself) is
    taken as it is. ``timeout_s`` bounds the rendezvous and every collective
    of the group.
    """
    if launcher in (None, "none"):
        return get_rank(), get_world_size()
    if launcher != "torch":
        raise ValueError(f"unknown launcher {launcher!r}; use 'none' or "
                         "'torch'")
    if dist.is_initialized():
        return get_rank(), get_world_size()
    missing = [v for v in TORCHRUN_VARIABLES if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"--launcher torch needs the environment torchrun sets; missing: "
            f"{', '.join(missing)}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    if on_card:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        backend or ("nccl" if on_card else "gloo"), init_method="env://",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


@contextlib.contextmanager
def process_group(launcher: str = "none", device=None,
                  timeout_s: float = DEFAULT_TIMEOUT_S):
    """``init_distributed`` for the span of a ``with`` block, yielding
    ``(rank, world_size)``; the group is destroyed on the way out, also on
    an exception, if this call created it (a group the caller set up stays
    the caller's)."""
    created = launcher not in (None, "none") and not dist.is_initialized()
    try:
        yield init_distributed(launcher, device=device, timeout_s=timeout_s)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


def coordination_barrier(name: str = "barrier", timeout_s: float = 600.0):
    """Wait until every process reaches this barrier, at most ``timeout_s``
    on gloo (``monitored_barrier``, which names the ranks that did not
    come); on NCCL a device barrier bounded by the group's timeout. A no-op
    without a group or in a group of one."""
    if get_world_size() == 1:
        return
    if dist.get_backend() == "gloo":
        try:
            dist.monitored_barrier(
                timeout=datetime.timedelta(seconds=timeout_s),
                wait_all_ranks=True)
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r}: {e}") from e
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])


def _on_backend(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the group's backend reduces it: the CPU for gloo, the
    current card for NCCL."""
    if dist.get_backend() == "gloo":
        return t.cpu()
    return t.cuda()


def _buckets(tensors: list, bucket_bytes: int):
    """Runs of consecutive tensors of one dtype and device, each at most
    ``bucket_bytes`` (a larger tensor alone)."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + nbytes > bucket_bytes):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def _flat_collective(tensors: list, collective,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """``collective(flat)`` on a few flat buckets of ``tensors``, written
    back into them in place."""
    for run in _buckets(tensors, bucket_bytes):
        flat = _on_backend(torch.cat([t.reshape(-1) for t in run]))
        collective(flat)
        flat = flat.to(run[0].device)
        torch._foreach_copy_(run, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in run]), run)])


def all_reduce_gradients(params, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum each parameter's ``.grad`` over the ranks, in place, in flat
    buckets of at most ``bucket_bytes``. Parameters without a gradient are
    left out (which ones have none is the model's structure, alike on every
    rank), and so are the slices of ``parallel.sharding.shard_state_fsdp``
    (their gradients were reduce-scattered in the backward pass). A no-op
    without a group; in a group of one, a sum over one rank."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params
             if p.grad is not None and getattr(p, "fsdp", None) is None]
    _flat_collective(grads, dist.all_reduce, bucket_bytes)


def broadcast_parameters(model: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers for every rank, in place."""
    if get_world_size() == 1:
        return
    tensors = list(model.parameters()) + list(model.buffers())
    _flat_collective([t.data for t in tensors],
                     lambda flat: dist.broadcast(flat, src))


@torch.no_grad()
def global_count(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks: a loss normaliser (a number of positives
    or of samples) over the global batch. No gradient flows through it. The
    identity without a group or in a group of one. Every rank must call it
    at the same point of its step, whatever its data. Over the count group
    of ``set_data_axis``."""
    if _count_group_size() == 1:
        return x
    y = _on_backend(x.detach().clone())
    dist.all_reduce(y, group=_DATA_AXIS["count_group"])
    return y.to(x.device)


@torch.no_grad()
def group_max(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s elementwise maximum over the ranks of ``group`` (exact: a
    maximum of floats rounds nothing). The identity where ``group`` is None
    or of one rank. No gradient."""
    return _group_reduce(x, group, dist.ReduceOp.MAX)


@torch.no_grad()
def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, as ``group_max``."""
    return _group_reduce(x, group, dist.ReduceOp.SUM)


def group_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis, in group order."""
    n = dist.get_world_size(group)
    src = _on_backend(x.contiguous())
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.reshape((n,) + tuple(x.shape)).to(x.device)


def _group_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if group is None or dist.get_world_size(group) == 1:
        return x
    y = _on_backend(x.detach().clone())
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def global_metrics(metrics: dict) -> dict:
    """Each 0-dim metric summed over the ranks (the ranks' losses, each
    normalised by global counts, sum to the global batch's loss), in one
    all-reduce, as float32 on the first metric's device. Unchanged without
    a group or in a group of one. Over the count group of
    ``set_data_axis``."""
    if _count_group_size() == 1 or not metrics:
        return metrics
    keys = list(metrics)
    device = torch.as_tensor(metrics[keys[0]]).device
    flat = torch.stack([torch.as_tensor(metrics[k], device=device).detach()
                        .to(torch.float32).reshape(()) for k in keys])
    flat = _on_backend(flat)
    dist.all_reduce(flat, group=_DATA_AXIS["count_group"])
    flat = flat.to(device)
    return dict(zip(keys, flat.unbind()))


def sync_global_value(x):
    """Rank 0's value for every rank (a broadcast of any picklable value).
    The identity without a group or in a group of one."""
    if get_world_size() == 1:
        return x
    box = [x]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_objects(x) -> list:
    """Every rank's ``x`` (picklable), in rank order."""
    if get_world_size() == 1:
        return [x]
    out = [None] * get_world_size()
    dist.all_gather_object(out, x)
    return out


def all_gather_eval_arrays(local: dict) -> dict:
    """Each rank's evaluation arrays (numpy, with one leading per-image
    axis of the same length on every rank: the shard loaders pad to it)
    concatenated along that axis in rank order, on every rank. The identity
    without a group or in a group of one."""
    if get_world_size() == 1:
        return dict(local)
    coordination_barrier("eval_gather")
    gathered = all_gather_objects({k: np.asarray(v)
                                   for k, v in local.items()})
    return {k: np.concatenate([g[k] for g in gathered], axis=0)
            for k in local}


def host_local_copy(tree):
    """A CPU copy of a state dict (or any nest of dicts, lists and
    tensors): what a checkpoint or a process-local evaluation reads."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: host_local_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_local_copy(v) for v in tree)
    return tree

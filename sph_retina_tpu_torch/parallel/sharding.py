"""Multi-axis sharding on ``torch.distributed``: a ("data", "space") mesh,
ZeRO-3 state sharding over "data", the ERP image width over "space", and
the row-sharded pairwise overlaps.

Semantics of the JAX package's ``parallel/sharding.py``. There GSPMD places
arrays by their shardings and inserts every collective; here each process
runs its part eagerly and the collectives are explicit:

- **The mesh** (``make_mesh``) is a ``DeviceMesh`` of ``(world // space,
  space)`` ranks over the default group, rank ``r`` at ``(r // space, r %
  space)``, row-major as the JAX mesh.
- **FSDP** (``shard_state_fsdp``): every parameter that ``fsdp_spec`` shards
  (the rule applied to the parameter's Flax-layout shape, then mapped back
  to torch's dimension: a conv's or a dense layer's output channel where it
  divides) is replaced by this rank's slice, momentum buffers and EMA
  shadows too. The module that owns a sharded parameter gathers it whole
  before each of its calls (one flat all-gather over the data group) and
  drops it after; the gather's backward reduce-scatters the gradient by sum
  (and sums it over "space", where the mesh has one). Parameters that
  ``fsdp_spec`` replicates keep their gradient all-reduce. The clip's norm
  sums the shards' squares over the data group; ``state_dict`` gives whole
  tensors under the unsharded names and ``load_state_dict`` takes them.
- **Space** (``partition_spatially``): the backbone and the neck run on this
  rank's columns. Each padded or windowed op (``models/resnet.py:Conv2d``,
  ``MaxPool2d``) first takes ``window_halo`` columns from its neighbours
  (zeros, ``-inf`` for a max-pool, at the ends of the chart: ERP padding is
  not circular); 1x1 convs, batch norms, L2Norm and FPN's nearest 2x
  upsample are exact on the local columns. A level whose width does not
  split evenly, or whose columns are fewer than a halo, is narrow: gathered
  whole, computed on every space rank, and split again where its output
  divides.
- **The split heads** (those that declare ``splits_over_space``:
  RetinaNet's and FCOS's): the neck's outputs stay on each rank's columns,
  and the head runs there too: its 3x3 convs, shared over the levels, take
  their halos level by level, and FCOS's GroupNorm takes its statistics
  over every rank's columns. A narrow level (P7 at 64x128 over 2 ranks) is
  computed whole on every rank, and the first space rank owns its anchors.
  Each rank assigns and scores only the anchors or points it owns
  (``head_part``): K1 runs at ``(B * G, N_rank)``; the assigner's each-gt
  maximum is an all-reduce MAX over "space"; the decoded-box positive
  gather keeps one process's rows over the ranks together; loss
  normalisers and metrics sum over every rank, and the loss is not scaled.
  A predict gathers the head's per-level outputs along the width before
  its top-k (``whole_levels``), so that it gives one process's detections.
- **The gathered heads** (SSD, whose hard-negative mining ranks each
  image's negatives over all its anchors, and Faster R-CNN, whose RoIAlign
  reads whole maps): the neck's outputs are gathered along the width; each
  space rank runs the head, the assignment and the loss on the whole maps,
  scales its loss by ``1 / space``; normalisers and metrics sum over
  "data".

Gradients are summed over every rank in both cases. A predict on a
partitioned model takes whole images, as one process's, and cuts its own
columns. Every gather, halo and reduce-scatter goes through the group's backend
(gloo: via the host).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _pair

from .distributed import (
    _on_backend,
    get_world_size,
    group_gather,
    set_data_axis,
)

DATA_AXIS = "data"
SPACE_AXIS = "space"

# set while a shape plan is recorded under a FakeTensorMode: no collective
_RECORDING = [False]


# --------------------------------------------------------------------------- #
# the mesh and the batch
# --------------------------------------------------------------------------- #
def make_mesh(n_devices: int | None = None, space: int = 1):
    """A ``DeviceMesh`` of shape ``(world // space, space)`` named
    ``("data", "space")`` over the default process group; rank ``r`` sits
    at ``(r // space, r % space)``. ``space=1`` is the plain data-parallel
    mesh (the trailing axis is kept). ``n_devices`` must be the group's size
    (one process a device); a world size not divisible by ``space`` raises
    ``ValueError`` before any group is touched. The device type is the
    group's (``init_distributed``: NCCL on the card, gloo on the CPU)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = get_world_size() if n_devices is None else int(n_devices)
    if space < 1 or world % space != 0:
        raise ValueError(f"{world} devices not divisible by space={space}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel.init_distributed)")
    if world != dist.get_world_size():
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{dist.get_world_size()} processes (one a device)")
    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                      torch.arange(world).reshape(world // space, space),
                      mesh_dim_names=(DATA_AXIS, SPACE_AXIS))


def _size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(axis)] if axis in names else 1


def batch_specs(batch: dict, mesh) -> dict:
    """The mesh axis of each dimension of each batch entry: the leading
    (batch) dimension over "data"; the image width also over "space" where
    the mesh has one. Images are ``(B, H, W, 3)``, as in the JAX package
    (the models view them as NCHW inside), so the width is dimension 2."""
    spatial = _size(mesh, SPACE_AXIS) > 1

    def spec(name, x):
        if name == "images" and spatial and x.ndim == 4:
            return (DATA_AXIS, None, SPACE_AXIS, None)
        return (DATA_AXIS,) + (None,) * (x.ndim - 1)

    return {k: spec(k, torch.as_tensor(v)) for k, v in batch.items()}


def shard_batch_spatial(batch: dict, mesh) -> dict:
    """This rank's part of a batch that every rank holds whole: rows by its
    data index, image columns by its space index (``batch_specs``); the
    other entries whole on each space rank. A dimension that does not split
    evenly raises, as do packed (I420) images with a "space" axis."""
    specs = batch_specs(batch, mesh)
    if _size(mesh, SPACE_AXIS) > 1 and "images" in batch \
            and SPACE_AXIS not in specs["images"]:
        raise ValueError("the space axis splits (B, H, W, 3) images; got "
                         f"{tuple(torch.as_tensor(batch['images']).shape)}")
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        for dim, axis in enumerate(specs[k]):
            if axis is None:
                continue
            n = _size(mesh, axis)
            if t.shape[dim] % n:
                raise ValueError(f"{k}: dimension {dim} ({t.shape[dim]}) "
                                 f"does not split over {n} {axis!r} ranks")
            w = t.shape[dim] // n
            t = t.narrow(dim, mesh.get_local_rank(axis) * w, w)
        out[k] = t
    return out


# --------------------------------------------------------------------------- #
# collectives (through the host on gloo)
# --------------------------------------------------------------------------- #
def _reduce_scatter(stacked: torch.Tensor, group) -> torch.Tensor:
    """``stacked`` (group size, ...) summed over the ranks; this rank's
    entry."""
    src = _on_backend(stacked.contiguous())
    out = src.new_empty(src.shape[1:])
    dist.reduce_scatter_tensor(out.reshape(-1), src.reshape(-1), group=group)
    return out.to(stacked.device)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    y = _on_backend(t.contiguous())
    dist.all_reduce(y, group=group)
    return y.to(t.device)


# --------------------------------------------------------------------------- #
# FSDP (ZeRO-3) over "data"
# --------------------------------------------------------------------------- #
def fsdp_spec(shape: tuple, axis_size: int, axis: str = DATA_AXIS) -> tuple:
    """Shard the last-most dimension divisible by ``axis_size``; replicate
    (``()``) if none is (biases of odd size, scalars). The tuple names the
    axis of each dimension, as the JAX function's ``PartitionSpec``.

    Applied to the Flax layout (``fsdp_dims``): for an HWIO conv kernel
    "last-most" is the output channel, the conventional FSDP cut."""
    if axis_size <= 1:
        return ()
    for i in reversed(range(len(shape))):
        if shape[i] % axis_size == 0 and shape[i] >= axis_size:
            return tuple(axis if j == i else None for j in range(len(shape)))
    return ()


def fsdp_dims(model: nn.Module, axis_size: int) -> dict:
    """Each parameter's torch dimension that ``shard_state_fsdp`` cuts over
    ``axis_size`` ranks, or None (replicated): ``fsdp_spec`` of the
    parameter's Flax-layout shape (``models/from_flax.py``: a torch conv
    weight is OIHW where Flax has HWIO, a dense one (out, in) where Flax has
    (in, out)), mapped back to torch's dimension."""
    from ..models.from_flax import flax_axes

    out = {}
    for name, p in model.named_parameters():
        axes = flax_axes(name, p.ndim)
        spec = fsdp_spec(tuple(p.shape[a] for a in axes), axis_size)
        out[name] = axes[spec.index(DATA_AXIS)] if spec else None
    return out


class ShardSpec(NamedTuple):
    """How a parameter is cut: along torch dimension ``dim`` into ``size``
    pieces over ``group`` (the data ranks), this rank holding piece
    ``index``; gradients also summed over ``replicas`` (the space ranks, or
    None)."""

    dim: int
    index: int
    size: int
    group: object
    replicas: object
    full_shape: tuple


def _gather_flat(shards: list, specs: list) -> list:
    """The whole tensors of ``shards`` (all over one group), by one flat
    all-gather."""
    flat = torch.cat([s.reshape(-1) for s in shards])
    got = group_gather(flat, specs[0].group)
    fulls, off = [], 0
    for s, spec in zip(shards, specs):
        pieces = got[:, off:off + s.numel()].reshape((spec.size,)
                                                     + tuple(s.shape))
        fulls.append(torch.cat(pieces.unbind(0), dim=spec.dim))
        off += s.numel()
    return fulls


def _reduce_scatter_flat(fulls: list, specs: list) -> list:
    """Each whole gradient summed over the data group (and over the
    replicas), this rank's piece, by one flat reduce-scatter."""
    size = specs[0].size
    parts = [f.chunk(size, spec.dim) for f, spec in zip(fulls, specs)]
    stacked = torch.stack([torch.cat([p[r].reshape(-1) for p in parts])
                           for r in range(size)])
    local = _reduce_scatter(stacked, specs[0].group)
    if specs[0].replicas is not None:
        local = _all_reduce(local, specs[0].replicas)
    out, off = [], 0
    for p, spec in zip(parts, specs):
        n = p[0].numel()
        out.append(local[off:off + n].reshape(p[0].shape))
        off += n
    return out


class _GatherParams(torch.autograd.Function):
    """Shards -> whole parameters; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, specs, *shards):
        ctx.specs = specs
        return tuple(_gather_flat(list(shards), specs))

    @staticmethod
    def backward(ctx, *grads):
        some = next(g for g in grads if g is not None)
        grads = [some.new_zeros(spec.full_shape) if g is None else g
                 for g, spec in zip(grads, ctx.specs)]
        shard_grads = _reduce_scatter_flat(grads, ctx.specs)
        return (None, *(g if need else None for g, need in
                        zip(shard_grads, ctx.needs_input_grad[1:])))


def _gather_hook(module, args, names):
    shards = [module._parameters[n] for n in names]
    specs = [s.fsdp for s in shards]
    if _RECORDING[0]:
        fulls = [torch.empty(spec.full_shape, dtype=s.dtype, device=s.device)
                 for s, spec in zip(shards, specs)]
    else:
        fulls = _GatherParams.apply(specs, *shards)
    for n, f in zip(names, fulls):
        module.__dict__[n] = f  # found before ``_parameters``' shard


def _release_hook(module, args, output, names):
    for n in names:
        module.__dict__.pop(n, None)


def _state_dict_hook(module, state_dict, prefix, local_metadata, names):
    shards = [module._parameters[n].detach() for n in names]
    fulls = _gather_flat(shards, [module._parameters[n].fsdp for n in names])
    for n, f in zip(names, fulls):
        state_dict[prefix + n] = f


def _load_hook(module, state_dict, prefix, *args, names):
    for n in names:
        spec = module._parameters[n].fsdp
        value = state_dict.get(prefix + n)
        if value is not None and tuple(value.shape) == spec.full_shape:
            state_dict[prefix + n] = value.chunk(spec.size,
                                                 spec.dim)[spec.index]


def shard_state_fsdp(model: nn.Module, optimizer, mesh):
    """ZeRO-3 over the mesh's "data" axis, in place: every parameter that
    ``fsdp_dims`` cuts (frozen ones too) becomes this rank's slice, and the
    optimiser's momentum buffers and EMA shadows with it (``optimizer`` may
    be None, or built before or after this call). Parameters that are
    replicated keep theirs whole. Returns ``(model, optimizer)``.

    Each module that owns a sharded parameter gathers it before every call
    and drops it after, so that Faster R-CNN's RoI head and OHEM's no-grad
    forward, called outside ``model(...)``, gather their own. Every rank
    must call the model, ``state_dict`` and the optimiser's ``step`` and
    ``state_dict`` at the same points (they gather). With one data rank
    nothing is sharded (``fsdp_spec`` replicates every leaf)."""
    size = _size(mesh, DATA_AXIS)
    if size > 1:
        index = mesh.get_local_rank(DATA_AXIS)
        group = mesh.get_group(DATA_AXIS)
        replicas = mesh.get_group(SPACE_AXIS) \
            if _size(mesh, SPACE_AXIS) > 1 else None
        dims = fsdp_dims(model, size)
        for mod_name, module in model.named_modules():
            names = tuple(n for n, _ in module.named_parameters(recurse=False)
                          if dims[f"{mod_name}.{n}" if mod_name else n]
                          is not None)
            if not names:
                continue
            for n in names:
                p = module._parameters[n]
                if hasattr(p, "fsdp"):
                    raise ValueError(f"{mod_name}.{n} is sharded already")
                dim = dims[f"{mod_name}.{n}" if mod_name else n]
                shard = nn.Parameter(
                    p.detach().chunk(size, dim)[index].clone(
                        memory_format=torch.contiguous_format),
                    requires_grad=p.requires_grad)
                shard.fsdp = ShardSpec(dim, index, size, group, replicas,
                                       tuple(p.shape))
                module._parameters[n] = shard
            module.register_forward_pre_hook(
                functools.partial(_gather_hook, names=names))
            module.register_forward_hook(
                functools.partial(_release_hook, names=names),
                always_call=True)
            module.register_state_dict_post_hook(
                functools.partial(_state_dict_hook, names=names))
            module.register_load_state_dict_pre_hook(
                functools.partial(_load_hook, names=names))
    if optimizer is not None:
        optimizer.reshard(model)
    return model, optimizer


def _is_sharded(p) -> bool:
    return getattr(p, "fsdp", None) is not None


def full_tensors(tensors: list, params: list) -> list:
    """``tensors`` (one a parameter, shaped as it: a gradient, a momentum
    buffer, an EMA shadow) whole: gathered where the parameter is sharded,
    the tensor itself where not. Every rank must call it alike."""
    out = list(tensors)
    idx = [i for i, p in enumerate(params) if _is_sharded(p)]
    if idx:
        fulls = _gather_flat([tensors[i].detach() for i in idx],
                             [params[i].fsdp for i in idx])
        for i, f in zip(idx, fulls):
            out[i] = f
    return out


def local_shards(tensors: list, params: list) -> list:
    """``tensors`` cut to their parameters' shards where a tensor is whole
    and its parameter sharded; the others as they are."""
    out = []
    for t, p in zip(tensors, params):
        spec = getattr(p, "fsdp", None)
        if spec is not None and tuple(t.shape) == spec.full_shape:
            t = t.chunk(spec.size, spec.dim)[spec.index].clone(
                memory_format=torch.contiguous_format)
        out.append(t)
    return out


def global_norm(params: list, tensors: list) -> torch.Tensor:
    """The 2-norm of all ``tensors`` (one a parameter) as one process
    holding them whole would compute it: a sharded parameter's squares
    summed over its data group, a replicated one's counted once."""
    norms = torch._foreach_norm(tensors)
    sharded = [n for n, p in zip(norms, params) if _is_sharded(p)]
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(norms))
    group = next(p.fsdp.group for p in params if _is_sharded(p))
    sq = _all_reduce(torch.stack(sharded).square().sum(), group)
    whole = [n for n, p in zip(norms, params) if not _is_sharded(p)]
    if whole:
        sq = sq + torch.stack(whole).square().sum()
    return sq.sqrt()


# --------------------------------------------------------------------------- #
# the "space" axis: width-sharded backbone and neck
# --------------------------------------------------------------------------- #
def _width(m) -> tuple[int, int, int, int]:
    """(kernel, stride, padding, dilation) of a conv or max-pool along the
    width."""
    return tuple(_pair(getattr(m, a))[1] for a in ("kernel_size", "stride",
                                                   "padding", "dilation"))


def window_halo(m: nn.Module) -> tuple[int, int]:
    """The (left, right) columns a rank takes from its neighbours before
    ``m`` (a conv or a max-pool) on its evenly split width: ``padding`` on
    the left, and on the right what the last output's window reaches past
    the rank's columns, ``dilation * (kernel - 1) + 1 - padding - stride``
    (at least 0). 7x7 s2 p3: (3, 2); 3x3 s2 p1: (1, 0); 3x3 s1 p1: (1, 1);
    VGG's 3x3 dilation-6 ``conv6``: (6, 6); 1x1 and 2x2 s2: (0, 0)."""
    k, s, p, d = _width(m)
    return p, max(0, d * (k - 1) + 1 - p - s)


def _out_width(g: int, m) -> int:
    k, s, p, d = _width(m)
    span = g + 2 * p - d * (k - 1) - 1
    if not getattr(m, "ceil_mode", False):
        return span // s + 1
    out = -(-span // s) + 1
    return out - 1 if (out - 1) * s >= g + p else out


def _apply(m, x: torch.Tensor, pad_w: int | None = None) -> torch.Tensor:
    """``m``'s operation with its own height padding and ``pad_w`` columns
    of width padding (default: its own)."""
    ph, pw = _pair(m.padding)
    pad = (ph, pw if pad_w is None else pad_w)
    if isinstance(m, nn.Conv2d):
        bias = None if m.bias is None else m.bias.to(x.dtype)
        return F.conv2d(x, m.weight.to(x.dtype), bias, m.stride, pad,
                        m.dilation, m.groups)
    return F.max_pool2d(x, m.kernel_size, m.stride, pad, m.dilation,
                        ceil_mode=m.ceil_mode)


def _like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` in ``x``'s memory format (channels-last where ``x`` is: the
    models' images are NHWC viewed as NCHW, and a convolution's arithmetic
    follows its input's layout)."""
    if x.dim() == 4 and x.stride(1) < x.stride(3):
        return y.contiguous(memory_format=torch.channels_last)
    return y


class _Halo(torch.autograd.Function):
    """This rank's columns with ``left`` columns of its left neighbour and
    ``right`` of its right one (``fill`` at the chart's ends); the backward
    sends each halo's gradient back to its owner, which adds it."""

    @staticmethod
    def forward(ctx, x, left, right, fill, axis):
        ctx.meta = (left, right, axis)
        w, r = x.shape[-1], axis.index
        got = group_gather(torch.cat([x[..., :right], x[..., w - left:]], -1),
                          axis.group)
        pad_l = got[r - 1][..., right:] if r > 0 \
            else torch.full_like(x[..., :left], fill)
        pad_r = got[r + 1][..., :right] if r < axis.size - 1 \
            else torch.full_like(x[..., :right], fill)
        return _like(torch.cat([pad_l, x, pad_r], -1), x)

    @staticmethod
    def backward(ctx, g):
        left, right, axis = ctx.meta
        w, r = g.shape[-1] - left - right, axis.index
        got = group_gather(torch.cat([g[..., :left], g[..., left + w:]], -1),
                          axis.group)
        gx = g[..., left:left + w].clone()
        if r < axis.size - 1 and left:
            gx[..., w - left:] += got[r + 1][..., :left]
        if r > 0 and right:
            gx[..., :right] += got[r - 1][..., left:]
        return _like(gx, g), None, None, None, None


class _WidthGather(torch.autograd.Function):
    """The space ranks' columns joined; the backward reduce-scatters the
    gradient by sum."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _like(torch.cat(group_gather(x, axis.group).unbind(0), -1), x)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        return _like(_reduce_scatter(torch.stack(g.chunk(axis.size, -1)),
                                     axis.group), g), None


class _GroupNormalize(torch.autograd.Function):
    """GroupNorm's ``(x - mean) / sqrt(var + eps)`` over each sample's
    channel groups and every space rank's columns, in fp32: the mean, then
    the centred sum of squares (two passes, each an all-reduce over
    "space"); the backward all-reduces the statistics' gradients."""

    @staticmethod
    def forward(ctx, x, groups, eps, axis):
        xg = x.float().reshape(x.shape[0], groups, -1)
        n = xg.shape[-1] * axis.size
        mean = _all_reduce(xg.sum(-1), axis.group) / n
        d = xg - mean[..., None]
        rstd = torch.rsqrt(_all_reduce(d.square().sum(-1), axis.group) / n
                           + eps)
        xhat = d * rstd[..., None]
        ctx.save_for_backward(xhat, rstd)
        ctx.axis = axis
        return _like(xhat.reshape(x.shape).to(x.dtype), x)

    @staticmethod
    def backward(ctx, g):
        xhat, rstd = ctx.saved_tensors
        axis = ctx.axis
        gg = g.float().reshape(xhat.shape)
        n = xhat.shape[-1] * axis.size
        sums = _all_reduce(torch.stack([gg.sum(-1), (gg * xhat).sum(-1)]),
                           axis.group) / n
        dx = (gg - sums[0][..., None] - xhat * sums[1][..., None]) \
            * rstd[..., None]
        return _like(dx.reshape(g.shape).to(g.dtype), g), None, None, None


class HeadPart(NamedTuple):
    """One space rank's part of a split head: whether it keeps each level's
    outputs (``levels``: a split level's columns, or a narrow level it
    owns), the rows each kept level has on this rank (``rows``), and the
    indices of its anchors or points in the flat ``(level, h, w, a)`` order
    (``indices``), in the order of its kept outputs joined."""

    levels: tuple
    rows: tuple
    indices: torch.Tensor

    def keep(self, outputs) -> list:
        """The kept levels of a head output (a list of per-level
        ``(B, rows, ...)`` tensors). The levels it drops (narrow ones that
        another rank owns) stay tied to the first kept one with a zero
        gradient: their backward, and the collectives of the neck's
        gathers in it, runs on every rank alike."""
        kept = [y for y, k in zip(outputs, self.levels) if k]
        if [y.shape[1] for y in kept] != list(self.rows) or not kept:
            raise ValueError(f"head outputs of {[y.shape[1] for y in kept]} "
                             f"rows where this rank owns {list(self.rows)}")
        dropped = [y for y, k in zip(outputs, self.levels) if not k]
        if dropped and torch.is_grad_enabled():
            kept[0] = _Tie.apply(kept[0], *dropped)
        return kept


class _Tie(torch.autograd.Function):
    """``x`` itself; ``others`` take a zero gradient."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.others))


def head_part(featmap_sizes, per_cell: int, size: int, index: int,
              device=None) -> HeadPart:
    """Space rank ``index`` of ``size``: its anchors (``per_cell`` a cell:
    RetinaNet's A) or points (1: FCOS) of levels of ``featmap_sizes`` (each
    ``(H, W)``, whole). A level whose width divides by ``size`` is split:
    the rank owns its ``W / size`` columns, each row's in ``(h, w, a)``
    order, as its head's ``(B, H * w * A, C)`` outputs hold them. A narrow
    level is whole on every rank and owned by rank 0 alone, so that every
    anchor enters one rank's loss, once. No collective."""
    levels, rows, indices, off = [], [], [], 0
    for h, w in featmap_sizes:
        if w % size == 0:
            cols = w // size
            cells = (torch.arange(h)[:, None] * w + index * cols
                     + torch.arange(cols)).reshape(-1)
        else:
            cells = torch.arange(h * w) if index == 0 else None
        levels.append(cells is not None)
        if cells is not None:
            rows.append(cells.numel() * per_cell)
            indices.append(off + (cells[:, None] * per_cell
                                  + torch.arange(per_cell)).reshape(-1))
        off += h * w * per_cell
    flat = torch.cat(indices) if indices else torch.zeros(0, dtype=torch.long)
    return HeadPart(tuple(levels), tuple(rows), flat.to(device))


class SpaceAxis:
    """The "space" axis of a partitioned model: its group, this rank's
    index, and the shape plan of each global input size (``plans``: each
    windowed op's, each FPN upsample's and each neck output's global input
    width, recorded once by a forward on fake tensors of the whole width;
    with a split ``head``, each of its calls' too, keyed by the op and the
    call's place among that op's calls in the forward, since the head's ops
    are shared over the levels). A tensor of global width ``g`` is split
    over the ranks where ``g`` divides by their number, else whole on
    each."""

    def __init__(self, mesh, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module | None = None):
        self.size = _size(mesh, SPACE_AXIS)
        self.index = mesh.get_local_rank(SPACE_AXIS)
        self.group = mesh.get_group(SPACE_AXIS)
        self.backbone, self.neck, self.head = backbone, neck, head
        self._shared = set() if head is None else set(head.modules())
        self.plans, self.plan, self.recording = {}, None, False
        self.calls = {}

    # hooks -------------------------------------------------------------- #
    def begin(self, backbone, args):
        """The backbone's forward pre-hook: the plan of this input's size."""
        if self.recording:
            return
        x = args[0]
        key = (x.shape[-2], x.shape[-1] * self.size)
        if key not in self.plans:
            self.plans[key] = self._record(x, key[1])
        self.plan = self.plans[key]

    def head_begin(self, head, args):
        """A split head's forward pre-hook: its calls counted afresh."""
        self.calls = {}

    def outputs(self, neck, args, outs):
        """The neck's forward hook: its split outputs gathered whole for a
        gathered head; kept on this rank's columns for a split one."""
        if self.recording:
            for i, y in enumerate(outs):
                self.plan[("out", i)] = y.shape[-1]
            return None
        widths = [self.plan[("out", i)] for i in range(len(outs))]
        if self.head is not None:
            for y, g in zip(outs, widths):
                (self._local if self._split(g) else self._whole)(y, g)
            return None
        return type(outs)(self.gather(y, g) if self._split(g)
                          else self._whole(y, g)
                          for y, g in zip(outs, widths))

    def _record(self, x, width: int) -> dict:
        from torch._subclasses.fake_tensor import FakeTensorMode

        plan = self.plan = {}
        self.recording = _RECORDING[0] = True
        try:
            with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
                feats = self.neck(self.backbone(torch.empty(
                    tuple(x.shape[:-1]) + (width,), dtype=x.dtype,
                    device=x.device)))
                if self.head is not None:
                    self.head(feats)
        finally:
            self.recording = _RECORDING[0] = False
        return plan

    def _key(self, m):
        """A backbone's or neck's op, or a split head's op and the place of
        this call among its calls."""
        if m not in self._shared:
            return m
        k = self.calls.get(m, 0)
        self.calls[m] = k + 1
        return (m, k)

    # ops ---------------------------------------------------------------- #
    def window(self, m, x):
        """A conv or max-pool on this rank's columns (the halo path), or on
        the whole width where the level is narrow."""
        key = self._key(m)
        if self.recording:
            self.plan[key] = x.shape[-1]
            return _apply(m, x)
        g = self.plan[key]
        g_out = _out_width(g, m)
        if self._split(g) and self._split(g_out):
            w, w_out = g // self.size, g_out // self.size
            left, right = window_halo(m)
            if w == _width(m)[1] * w_out and max(left, right) <= w:
                x = self._local(x, g)
                if left or right:
                    fill = float("-inf") if isinstance(m, nn.MaxPool2d) \
                        else 0.0
                    x = _Halo.apply(x, left, right, fill, self)
                return _apply(m, x, pad_w=0)[..., :w_out]
        y = _apply(m, self.gather(x, g) if self._split(g)
                   else self._whole(x, g))
        return self.scatter(y) if self._split(g_out) else y

    def group_norm(self, m, x):
        """A split head's GroupNorm: statistics over every rank's columns
        where the level is split, the module's own where it is narrow; the
        affine on the local columns."""
        key = self._key(m)
        if self.recording:
            self.plan[key] = x.shape[-1]
        if self.recording or not self._split(self.plan[key]):
            return F.group_norm(x, m.num_groups, m.weight, m.bias, m.eps)
        xhat = _GroupNormalize.apply(self._local(x, self.plan[key]),
                                     m.num_groups, m.eps, self)
        shape = (1, -1, 1, 1)
        return xhat * m.weight.view(shape) + m.bias.view(shape)

    def upsample(self, owner, i: int, x):
        """FPN's nearest 2x upsample of level ``i`` (exact on the local
        columns of a split level)."""
        if self.recording:
            self.plan[(owner, i)] = x.shape[-1]
        y = F.interpolate(x, scale_factor=2, mode="nearest")
        if self.recording or self._split(self.plan[(owner, i)]):
            return y
        return self.scatter(y) if self._split(y.shape[-1]) else y

    def gather(self, x, g: int):
        return _WidthGather.apply(self._local(x, g), self)

    def scatter(self, y):
        """This rank's columns of a whole tensor."""
        w = y.shape[-1] // self.size
        return y[..., self.index * w:(self.index + 1) * w]

    def columns(self, images: torch.Tensor) -> torch.Tensor:
        """This rank's columns of whole ``(B, H, W, 3)`` images."""
        w = images.shape[2] // self.size
        if w * self.size != images.shape[2]:
            raise ValueError(f"{images.shape[2]} columns do not split over "
                             f"{self.size} space ranks")
        return images[:, :, self.index * w:(self.index + 1) * w]

    def join(self, levels, featmap_sizes) -> list:
        """A split head's per-level outputs ``(B, H * w * A, ...)`` whole:
        the split levels' columns gathered along the width (no gradient)."""
        out = []
        for y, (h, w) in zip(levels, featmap_sizes):
            if self._split(w):
                grid = y.reshape(y.shape[0], h, w // self.size, -1)
                whole = torch.cat(group_gather(grid, self.group).unbind(0), 2)
                y = whole.reshape((y.shape[0], -1) + tuple(y.shape[2:]))
            out.append(y)
        return out

    def _split(self, g: int) -> bool:
        return g % self.size == 0

    def _local(self, x, g: int):
        if x.shape[-1] * self.size != g:
            raise ValueError(f"{x.shape[-1]} columns on a space rank where "
                             f"the level is {g} wide: is the batch split by "
                             "shard_batch_spatial?")
        return x

    def _whole(self, x, g: int):
        if x.shape[-1] != g:
            raise ValueError(f"{x.shape[-1]} columns where the narrow level "
                             f"is {g} wide")
        return x


def split_head(model: nn.Module) -> SpaceAxis | None:
    """The space axis of a model whose head is split over it, else None."""
    axis = getattr(model, "space_axis", None)
    return axis if axis is not None and axis.head is not None else None


def whole_levels(model: nn.Module, outputs, featmap_sizes) -> tuple:
    """A head's outputs (a tuple of per-level lists) as one process's: on a
    split head, each level's columns gathered (``SpaceAxis.join``)."""
    axis = split_head(model)
    if axis is None:
        return outputs
    return tuple(axis.join(levels, featmap_sizes) for levels in outputs)


def partition_spatially(model: nn.Module, mesh) -> nn.Module:
    """Make a built detector width-sharded over the mesh's "space" axis, in
    place, and return it: the backbone's and the neck's convs and max-pools
    (and FPN's upsample) go through a ``SpaceAxis``. Each rank is then fed
    its columns (``shard_batch_spatial``). A mesh with ``space == 1`` leaves
    the model as it is. One partitioned model trains in a process at a time
    (the data axis is the process's).

    A head that declares ``splits_over_space`` (RetinaNet's and FCOS's) is
    split: its convs (and FCOS's GroupNorms) go through the axis too, the
    neck's outputs stay on each rank's columns, a narrow level's anchors
    are the first space rank's, each rank's loss is its anchors' part, and
    normalisers and metrics sum over every rank (``set_data_axis(data
    group, 1, None)``). Any other head (SSD's, Faster R-CNN's) is gathered:
    the neck's outputs are gathered whole, normalisers and metrics sum over
    the data group and each loss is scaled by ``1 / space``
    (``set_data_axis(data group, space, data group)``)."""
    size = _size(mesh, SPACE_AXIS)
    if size == 1:
        return model
    if getattr(model, "space_axis", None) is not None:
        raise ValueError("the model is partitioned already")
    from ..models.fcos import GroupNorm
    from ..models.fpn import FPN
    from ..models.resnet import Conv2d, MaxPool2d

    head = getattr(model, "bbox_head", None)
    if not getattr(head, "splits_over_space", False):
        head = None
    axis = SpaceAxis(mesh, model.backbone, model.neck, head)
    for part in (model.backbone, model.neck) + ((head,) if head else ()):
        for m in part.modules():
            if isinstance(m, (Conv2d, MaxPool2d, FPN, GroupNorm)):
                m.space = axis
    model.backbone.register_forward_pre_hook(axis.begin)
    model.neck.register_forward_hook(axis.outputs)
    if head is not None:
        head.register_forward_pre_hook(axis.head_begin)
    data = mesh.get_group(DATA_AXIS)
    if head is not None:
        set_data_axis(data, 1, None)
    else:
        set_data_axis(data, size, data)
    model.space_axis = axis
    return model


# --------------------------------------------------------------------------- #
# the row-sharded pairwise overlaps
# --------------------------------------------------------------------------- #
def sharded_pairwise_overlaps(b1: torch.Tensor, b2: torch.Tensor, mesh,
                              backend: str = "sph2pob_efficient"
                              ) -> torch.Tensor:
    """Pairwise spherical IoU ``(N, M)`` with the rows of ``b1`` split over
    the mesh's "data" axis: padded with ones to a multiple of it, each rank
    computes its ``(N/d, M)`` slab against the whole ``b2`` with
    ``iou.api.sph_overlaps`` (eager; never the fused kernel), an all-gather
    joins the slabs, the padding is stripped. Every rank returns the whole
    matrix (the JAX function's row-sharded array). No gradient."""
    from ..iou.api import sph_overlaps

    size = _size(mesh, DATA_AXIS)
    n, pad = b1.shape[0], (-b1.shape[0]) % size
    if pad:
        b1 = torch.cat([b1, b1.new_ones((pad, b1.shape[1]))])
    rows = b1.shape[0] // size
    index = mesh.get_local_rank(DATA_AXIS)
    with torch.no_grad():
        local = sph_overlaps(b1[index * rows:(index + 1) * rows], b2,
                             backend, is_aligned=False)
        out = group_gather(local, mesh.get_group(DATA_AXIS))
    return out.reshape(size * rows, -1)[:n]

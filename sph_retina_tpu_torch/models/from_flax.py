"""Carries the JAX package's variables across into the port's ``state_dict``.

``from_flax(params, batch_stats)`` takes the nested dicts of numpy arrays
that ``utils.publish.load_published`` returns — the layout of the Flax
modules of the JAX package — and returns a flat ``state_dict`` for the
port's detectors (``SphRetinaNet``, ``SphFCOS``, ``SphSSD``,
``SphFasterRCNN``):

- conv ``kernel`` (H, W, I, O) -> ``weight`` (O, I, H, W), grouped convs too
  (both frameworks keep I = in_channels / groups there); dense ``kernel``
  (I, O) -> ``weight`` (O, I); ``bias`` as is;
- batch norm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``; every other
  ``scale`` (GroupNorm, SSD's L2Norm, FCOS's per-level scalar) -> ``weight``;
- Flax paths (``backbone/layer1_0/conv1``) -> module paths
  (``backbone.layer1_0.conv1``); the port's modules carry the same names.

``load_flax_variables`` then loads it strictly: a missing key, an extra key
or a shape that differs raises. ``to_flax`` is the inverse of ``from_flax``
(the round trip is exact), so that parameters, gradients and optimiser state
of the two packages can be compared leaf by leaf in one layout.
"""

from __future__ import annotations

import numpy as np
import torch

_BN_STATS = {"mean": "running_mean", "var": "running_var"}
# a kernel's Flax dimension at each torch dimension: conv (H, W, I, O) ->
# (O, I, H, W), dense (I, O) -> (O, I)
_KERNEL_AXES = {4: (3, 2, 0, 1), 2: (1, 0)}


def flax_axes(name: str, ndim: int) -> tuple:
    """The torch dimension of each dimension of the Flax leaf that holds
    the parameter ``name`` (``ndim`` dimensions): a 4-d or 2-d ``weight``
    is a kernel, transposed as ``from_flax`` transposes it; any other
    leaf keeps its order."""
    if name.rsplit(".", 1)[-1] == "weight" and ndim in _KERNEL_AXES:
        return tuple(_KERNEL_AXES[ndim].index(f) for f in range(ndim))
    return tuple(range(ndim))


def _walk(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def from_flax(params: dict, batch_stats: dict | None = None) -> dict:
    """Flax ``params`` / ``batch_stats`` trees -> flat torch ``state_dict``."""
    out: dict = {}

    def put(key, value):
        if key in out:
            raise KeyError(f"duplicate key {key!r} while converting")
        # np.array, not np.ascontiguousarray: that one makes a 0-d leaf 1-d
        out[key] = torch.from_numpy(np.array(value, np.float32, order="C"))

    for path, leaf in _walk(params):
        module, name = ".".join(path[:-1]), path[-1]
        if name == "kernel":
            if leaf.ndim not in (2, 4):
                raise ValueError(
                    f"{'/'.join(path)}: expected an (H, W, I, O) conv kernel "
                    f"or an (I, O) dense one, got shape {leaf.shape}")
            put(f"{module}.weight", leaf.transpose(_KERNEL_AXES[leaf.ndim]))
        elif name == "scale":
            put(f"{module}.weight", leaf)
        elif name == "bias":
            put(f"{module}.bias", leaf)
        else:
            raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
    for path, leaf in _walk(batch_stats or {}):
        module, name = ".".join(path[:-1]), path[-1]
        if name not in _BN_STATS:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        put(f"{module}.{_BN_STATS[name]}", leaf)
    return out


def to_flax(state_dict: dict) -> tuple[dict, dict]:
    """Flat ``state_dict`` (or any dict of tensors under its keys, such as
    gradients by parameter name) -> nested ``(params, batch_stats)`` trees of
    numpy arrays in the Flax layout. 4-d ``weight`` is a conv kernel, 2-d
    a dense one, 1-d or 0-d ``weight`` a ``scale`` (of a batch norm, a group
    norm, an L2Norm, an FCOS level)."""
    params: dict = {}
    batch_stats: dict = {}
    stats_names = {v: k for k, v in _BN_STATS.items()}

    def put(tree, path, value):
        for part in path[:-1]:
            tree = tree.setdefault(part, {})
        tree[path[-1]] = value

    for key, tensor in state_dict.items():
        *module, name = key.split(".")
        value = tensor.detach().cpu().numpy()
        if name in stats_names:
            put(batch_stats, module + [stats_names[name]], value)
        elif name == "weight" and value.ndim in (2, 4):
            put(params, module + ["kernel"], np.ascontiguousarray(
                value.transpose(flax_axes(name, value.ndim))))
        elif name == "weight" and value.ndim <= 1:
            put(params, module + ["scale"], value)
        elif name == "bias":
            put(params, module + ["bias"], value)
        else:
            raise KeyError(f"unknown state_dict entry {key!r} of shape "
                           f"{tuple(value.shape)}")
    return params, batch_stats


def load_flax_variables(model: torch.nn.Module, params: dict,
                        batch_stats: dict | None = None) -> None:
    """Convert and load into ``model``; fails loudly on a missing key, an
    extra key and a shape mismatch."""
    state = from_flax(params, batch_stats)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(
            f"checkpoint does not fit the model: missing {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''} ({len(missing)}), "
            f"unexpected {extra[:8]}{'...' if len(extra) > 8 else ''} "
            f"({len(extra)})")
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(
                f"shape mismatch at {k}: model {tuple(own[k].shape)} vs "
                f"checkpoint {tuple(v.shape)}")
    model.load_state_dict(state, strict=True)

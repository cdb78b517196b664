"""Publishable single-file inference checkpoints.

A *published* checkpoint is one compressed ``.npz`` holding only params +
batch_stats in the Flax layout (flattened, '/'-joined keys under
``params/`` and ``batch_stats/``) plus a small JSON meta record under
``__meta__``, its file name suffixed with a hash of its content — the file
the JAX package's ``save_published`` writes and its ``load_published``
reads, so that either package loads what the other published. numpy only.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np


def _flatten(tree: dict, prefix: str) -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}/"))
        else:
            out[prefix + str(key)] = np.asarray(val)
    return out


def _unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_published(path: str, params: dict, batch_stats: dict | None = None,
                   meta: dict | None = None) -> str:
    """Write the published npz of nested ``params`` / ``batch_stats`` dicts
    of arrays (``models.from_flax.to_flax`` of a ``state_dict``); returns
    the final path, ``<path without .npz>-<first 8 hex of sha256>.npz``."""
    flat = _flatten(params, "params/")
    if batch_stats:
        flat.update(_flatten(batch_stats, "batch_stats/"))
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), np.uint8)
    # savez_compressed appends ".npz" to a suffix-less path; normalise first
    # so that the hash and the rename below see the file actually written
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, **flat)
    with open(path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    final = f"{path[:-4]}-{sha[:8]}.npz"
    os.replace(path, final)
    return final


def load_published(path: str) -> tuple:
    """Returns (params, batch_stats, meta) from a published npz."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__", np.zeros(0, np.uint8))
                            ).decode() or "{}")
    return (_unflatten(flat, "params/"),
            _unflatten(flat, "batch_stats/"), meta)

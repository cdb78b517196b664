"""Reads publishable single-file inference checkpoints.

A *published* checkpoint is one compressed ``.npz`` holding only params +
batch_stats (flattened, '/'-joined keys under ``params/`` and
``batch_stats/``) plus a small JSON meta record under ``__meta__`` — the
file the JAX package's ``save_published`` writes. numpy only.
"""

from __future__ import annotations

import json

import numpy as np


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


def load_published(path: str) -> tuple:
    """Returns (params, batch_stats, meta) from a published npz."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__", np.zeros(0, np.uint8))
                            ).decode() or "{}")
    return (_unflatten(flat, "params/"),
            _unflatten(flat, "batch_stats/"), meta)

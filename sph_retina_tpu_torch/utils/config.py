"""Python-file config system with ``_base_`` composition and dotted overrides.

The port's own copy of the loader that reads ``configs/*.py`` (stdlib only):
a config file is a python module whose module-level variables form a dict;
``_base_`` lists parent files merged depth-first (child wins, dicts merge
recursively, ``_delete_=True`` replaces instead of merging), ``${a.b}``
references resolve against the merged result, and ``a.b.c=value`` strings
override single keys.
"""

from __future__ import annotations

import ast
import copy
import os
import runpy
from typing import Any


def _strip_delete(v):
    """Drop ``_delete_`` markers from a config subtree (mmcv pops the key
    whatever its value, so it must never reach consumers)."""
    if isinstance(v, dict):
        return {k: _strip_delete(x) for k, x in v.items() if k != "_delete_"}
    return copy.deepcopy(v)


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and v.get("_delete_"):
            # mmcv Config parity: _delete_=True replaces the inherited dict
            # wholesale instead of merging into it (needed when a child
            # swaps e.g. loss_bbox.type and the parent's kwargs must not
            # leak into the new type's signature).
            out[k] = _strip_delete(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], _strip_delete(v)
                                 if "_delete_" in v else v)
        else:
            out[k] = _strip_delete(v) if isinstance(v, dict) else copy.deepcopy(v)
    return out


def _load(path: str) -> dict:
    ns = runpy.run_path(path)
    cfg = {k: v for k, v in ns.items()
           if not k.startswith("_") and not callable(v)
           and not isinstance(v, type(os))}
    bases = ns.get("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        merged = _deep_merge(merged, _load(os.path.join(os.path.dirname(path), b)))
    return _deep_merge(merged, cfg)


def replace_cfg_vals(cfg: dict) -> dict:
    """Resolve ``${a.b.c}`` references in string values against the config
    itself (reference ``mmdet/utils/replace_cfg_vals.py``, applied by
    tools/train.py:118-120 there). A string that is exactly one reference
    keeps the referenced value's type; embedded references stringify."""
    import re

    pattern = re.compile(r"\$\{([\w.]+)\}")

    def lookup(dotted: str):
        node: Any = cfg
        for p in dotted.split("."):
            node = node[p]
        return node

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x) for x in v)
        if isinstance(v, str):
            m = pattern.fullmatch(v)
            if m:
                return lookup(m.group(1))
            return pattern.sub(lambda mm: str(lookup(mm.group(1))), v)
        return v

    return walk(cfg)


def load_config(path: str) -> dict:
    """Load a python config file: `_base_` composition (depth-first, child
    wins) + ``${key}`` interpolation over the merged result."""
    return replace_cfg_vals(_load(path))


def apply_overrides(cfg: dict, options: list[str]) -> dict:
    """Apply 'a.b.c=value' overrides (values parsed as python literals)."""
    cfg = copy.deepcopy(cfg)
    for opt in options or []:
        key, _, raw = opt.partition("=")
        try:
            value: Any = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg

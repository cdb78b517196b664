"""Frozen roofline of the fused pairwise Sph2Pob IoU kernel K1.

The elementwise fp32 operations of each stage of the kernel's body, counted
once (arithmetic, compare, select, sin / cos, sqrt each one): the pair's
jitter flag, one box's state with its cull radius on each side (the kernel
makes both jitter states of every box), the cull, and the body that the
pairs the cull leaves run. Counted by ``chip_smoke.py:stage_ops`` on the
port's plain version (``ops/fused_iou.py``) at commit cc123a5 and frozen
here: a later change to the port's plain version does not move the
yardstick. ``count_stage_ops`` counts them again on the benchmark's frozen
copy of that arithmetic (``reference/sph2pob_iou.py``); a test holds the two
equal.

Peaks of one H100 SXM (NVIDIA's data sheet): 3.35e12 bytes/s of device
memory, 67e12 fp32 operations/s outside the tensor cores.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .reference import sph2pob_iou as plain

STAGE_OPS = {
    4: {"flag": 15, "side1": 31, "side2": 31, "cull": 14, "body": 798},
    5: {"flag": 19, "side1": 37, "side2": 37, "cull": 14, "body": 810},
}
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12


def bound_seconds(rows: int, anchors: int, d: int, culled: int) -> dict:
    """The least time the card could take for ``rows`` boxes against
    ``anchors`` boxes of width ``d`` of which ``culled`` pairs are disjoint:
    the larger of the bytes (inputs read once, the (rows, anchors) output
    written once) over the memory rate and the operations over the fp32
    rate."""
    ops = STAGE_OPS[d]
    pairs = rows * anchors
    n_ops = (2 * (rows * ops["side1"] + anchors * ops["side2"])
             + (ops["flag"] + ops["cull"]) * pairs
             + ops["body"] * (pairs - culled))
    n_bytes = 4 * ((rows + anchors) * d + pairs)
    by_bytes = n_bytes / PEAK_BYTES_PER_S
    by_ops = n_ops / PEAK_FP32_OPS_PER_S
    return {"seconds": max(by_bytes, by_ops), "operations": n_ops,
            "bytes": n_bytes,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


class _ElementCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by_numel = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and not func.is_view \
                and "zeros_like" not in str(func):
            self.by_numel[out.numel()] += 1
        return out


def _seeded_boxes(n, d, rng):
    cols = [rng.uniform(0.0, 360.0, n), rng.uniform(0.0, 180.0, n),
            rng.uniform(1.0, 100.0, n), rng.uniform(1.0, 100.0, n)]
    if d == 5:
        cols.append(rng.uniform(-90.0, 90.0, n))
    return np.stack(cols, axis=1).astype(np.float32)


def count_stage_ops(d: int) -> dict:
    """The stage counts of the pairwise kernel, counted afresh on the frozen
    plain copy: states on 6 and 7 boxes alone, the flag, cull and body on
    their 42 pairs."""
    rng = np.random.default_rng(0)
    n1, n2, pairs = 6, 7, 42
    b1 = torch.from_numpy(_seeded_boxes(n1, d, rng))[:, None]
    b2 = torch.from_numpy(_seeded_boxes(n2, d, rng))[None]
    b1 = [b1[..., c] for c in range(d)]
    b2 = [b2[..., c] for c in range(d)]
    counts: dict = {}

    def count(name, numel, fn):
        with _ElementCounter() as c:
            out = fn()
        counts[name] = counts.get(name, 0) + c.by_numel[numel]
        return out

    count("flag", pairs, lambda: plain.jitter_flag(b1, b2))
    flag = torch.tensor(False)
    s1 = count("side1", n1, lambda: plain.side_state(b1, 1, flag))
    s2 = count("side2", n2, lambda: plain.side_state(b2, 2, flag))
    r1 = count("side1", n1, lambda: plain.cull_radius(s1))
    r2 = count("side2", n2, lambda: plain.cull_radius(s2))
    count("cull", pairs, lambda: plain.disjoint(s1, r1, s2, r2))
    count("body", pairs, lambda: plain.pair_body(s1, s2))
    return counts

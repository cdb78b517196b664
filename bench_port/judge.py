"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to a limit of the cell's own
(``cells/<workload>.json``).

Training (the step object of the window, its first three steps):

- ``loss_gap``: the largest relative gap of a step's loss (the total the
  step minimises) over the checked steps; ``loss_gap.<term>`` the same of
  one of its terms (``loss_bbox``: a term whose rounding does not swing
  with the seed's random network, as the classification term's does);
- ``grad_gap``: the worst leaf's gap between the norms of the first step's
  gradient (clipped, as the optimiser applies it; the program's worked out
  from its momentum buffers after one step), over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
- ``update_gap``: the same of the parameters' change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (their change is the weight decay's alone) and those
  whose change the float32 parameters cannot resolve (``resolvable``).

A cell compares the numbers its limits name; the others are reported by
``bench_port.calibrate`` only.

Detection (a sample of the window's batches, drawn from the seed):

- ``missed``: the worst image's share of the reference's best
  ``max_per_img / 2`` detections that no program detection of the class
  overlaps by ``MATCH_IOU`` (a program that drops, moves or relabels
  answers, or suppresses wrongly, misses them);
- ``score_gap``: the largest gap between a program detection's score and
  the score of the reference's candidate of its class that overlaps it
  most (0 where none overlaps by ``MATCH_IOU``).
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from .reference.sph2pob_iou import pairwise_iou

MATCH_IOU = 0.4  # below the NMS threshold: a borderline suppression still
# pairs the box one side kept with the one the other kept instead
DEAD_LEAF = 1e-3
RESOLVE = 8


def _gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's gap between the program's and the reference's norms,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    n_ref = {k: float(ref[k].float().norm()) for k in names}
    med = statistics.median(n_ref.values())
    return [abs(float(prog[k].float().norm()) - n_ref[k])
            / max(n_ref[k], med, 1e-30) for k in names]


def _ulp(x: float) -> float:
    """The spacing of float32 numbers at ``x``."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 23)


def resolvable(ref: dict, names) -> list:
    """The leaves whose reference change over the checked steps is at least
    ``RESOLVE`` float32 spacings of their values, element for element (in
    root mean square). The warm-up's first steps move a leaf of large
    values (batch-norm scales at 1, the classifier's prior bias at -4.6) by
    less than a spacing: its stored change is the rounding of its values,
    on both sides, and not the update."""
    out = []
    for k in names:
        d, p = ref["delta"][k].float(), ref["p0"][k].float()
        rms_d = float(d.norm()) / math.sqrt(d.numel())
        rms_p = float(p.norm()) / math.sqrt(p.numel())
        if rms_d >= RESOLVE * _ulp(rms_p):
            out.append(k)
    return out


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: ``losses`` (a dict of floats a step: the total
    ``loss`` and its terms), ``grad`` and ``delta`` (tensors by leaf name);
    ``ref`` also ``p0``, the leaves' values before the steps."""
    losses = list(zip(prog["losses"], ref["losses"]))
    loss_gaps = {
        "loss_gap" if k == "loss" else f"loss_gap.{k}":
        max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30) for p, r in losses)
        for k in ref["losses"][0] if k in prog["losses"][0]}
    names = sorted(ref["grad"])
    g_ref = {k: float(ref["grad"][k].norm()) for k in names}
    med = statistics.median(g_ref.values())
    live = [k for k in names if g_ref[k] >= DEAD_LEAF * med]
    moved = resolvable(ref, live)
    update = _gaps(prog["delta"], ref["delta"], moved) if moved else [0.0]
    return {**loss_gaps,
            "grad_gap": max(_gaps(prog["grad"], ref["grad"], names)),
            "update_gap": max(update)}


def _split(per_class) -> tuple:
    """A result as ``inference_detector`` returns it -> boxes, scores,
    labels."""
    boxes, scores, labels = [], [], []
    for c, rows in enumerate(per_class):
        rows = np.asarray(rows, np.float32)
        boxes.append(rows[:, :-1])
        scores.append(rows[:, -1])
        labels.append(np.full(len(rows), c))
    return (np.concatenate(boxes), np.concatenate(scores),
            np.concatenate(labels))


def _same_class_iou(b1, l1, b2, l2, device) -> np.ndarray:
    if len(b1) == 0 or len(b2) == 0:
        return np.zeros((len(b1), len(b2)), np.float32)
    iou = pairwise_iou(torch.from_numpy(np.ascontiguousarray(b1)).to(device),
                       torch.from_numpy(np.ascontiguousarray(b2)).to(device))
    return np.where(l1[:, None] == l2[None, :], iou.cpu().numpy(), 0.0)


def detect_numbers(results: list, refs: list, max_per_img: int,
                   device) -> dict:
    """``results``: per image, the program's per-class arrays; ``refs``:
    per image, the reference's ``kept`` and ``candidates`` (each boxes,
    scores, labels; best first)."""
    missed, gap = 0.0, 0.0
    core = max_per_img // 2
    for res, ref in zip(results, refs):
        b, s, lab = _split(res)
        kb, ks, kl = (x[:core] for x in ref["kept"])
        iou = _same_class_iou(kb, kl, b, lab, device)
        if len(kb):
            missed = max(missed, float(
                (iou.max(axis=1, initial=0.0) < MATCH_IOU).mean()))
        cb, cs, cl = ref["candidates"]
        iou = _same_class_iou(b, lab, cb, cl, device)
        if len(b):
            best = iou.argmax(axis=1) if iou.shape[1] else np.zeros(len(b), int)
            matched = iou.max(axis=1, initial=0.0) >= MATCH_IOU
            ref_s = np.where(matched, cs[best] if len(cs) else 0.0, 0.0)
            gap = max(gap, float(np.abs(s - ref_s).max()))
    return {"missed": missed, "score_gap": gap}


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """The numbers that the cell compares (those its ``limits`` name), each
    finite and at or under its limit."""
    checks = {k: {"value": float(numbers.get(k, math.nan)), "limit": v}
              for k, v in limits.items()}
    ok = bool(checks) and all(np.isfinite(c["value"])
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks


def worst_leaves(prog: dict, ref: dict, key: str, top: int = 3) -> list:
    """The ``top`` leaves of the largest gap of ``key`` (``grad`` or
    ``delta``): name, the program's norm, the reference's, the gap."""
    n_ref = {k: float(ref[key][k].float().norm()) for k in ref[key]}
    med = statistics.median(n_ref.values())
    rows = [(k, float(prog[key][k].float().norm()), n_ref[k])
            for k in n_ref]
    rows = [(k, p, r, abs(p - r) / max(r, med, 1e-30)) for k, p, r in rows]
    return sorted(rows, key=lambda x: -x[3])[:top]

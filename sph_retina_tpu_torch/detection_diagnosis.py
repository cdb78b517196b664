"""Decompose an AP delta into its failure modes.

    python -m sph_retina_tpu_torch.detection_diagnosis RUN_DIR [RUN_DIR ..] \\
        [--ann work_dirs/sphere_bench/annotations/instances_val.json] \\
        [--score-thr 0.3] [--out report.json] [--device cuda|cpu]

Reads the ``eval_arrays.npz`` that ``ap_study`` saves in each run directory
and reports, for each run:

- at a score threshold, how many detections an image are **hits** (unbiased
  IoU >= 0.5 to a GT of their class), **mislocalised** (0.1 <= IoU < 0.5)
  or **hallucinated** (IoU < 0.1 to every GT of their class);
- GT recall at IoU 0.5 over all the retained detections (the localisation
  ceiling, whatever the scores);
- the mean score of hits and of hallucinations;
- the same for polar-tagged and untagged images, when the val annotation
  file is given.

That separates a model that detects nothing (low recall) from one that
floods high-scoring garbage. The unbiased IoUs run on the CUDA device
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .iou import sph_overlaps
from .utils.device import resolve_device


def _pairwise_unbiased(dets, gts, device=None):
    """(K, D) x (G, D) -> (K, G) unbiased IoU of the boxes' first 4 columns,
    computed on ``device``."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float32)
    device = resolve_device(device)
    with torch.no_grad():
        iou = sph_overlaps(
            torch.from_numpy(np.ascontiguousarray(dets[:, :4])).to(device),
            torch.from_numpy(np.ascontiguousarray(gts[:, :4])).to(device),
            "unbiased")
    return iou.cpu().numpy()


def diagnose(npz_path, score_thr=0.3, strata_by_img=None, device=None):
    a = np.load(npz_path)
    n_img = a["boxes"].shape[0]
    out = {"all": _zero(), "polar": _zero(), "body": _zero()}
    for i in range(n_img):
        v = a["valid"][i]
        boxes, scores, labels = a["boxes"][i][v], a["scores"][i][v], \
            a["labels"][i][v]
        m = a["gt_mask"][i]
        gb, gl = a["gt_boxes"][i][m], a["gt_labels"][i][m]
        iou = _pairwise_unbiased(boxes, gb, device)
        same = labels[:, None] == gl[None, :]
        best = np.where(same, iou, 0.0).max(axis=1) if len(gb) else \
            np.zeros(len(boxes), np.float32)
        keep = scores >= score_thr
        buckets = ["all"]
        if strata_by_img is not None:
            tags = strata_by_img.get(int(a["img_id"][i]), ())
            buckets.append("polar" if "polar" in tags else "body")
        for b in buckets:
            s = out[b]
            s["n_images"] += 1
            s["gt_total"] += len(gb)
            if len(gb) and len(boxes):
                # an image without detections recalls none of its GTs (the
                # JAX tool's max over no rows raises there: ROADMAP C23)
                gbest = np.where(same, iou, 0.0).max(axis=0)
                s["gt_recalled"] += int((gbest >= 0.5).sum())
            s["dets"] += int(keep.sum())
            s["hits"] += int((keep & (best >= 0.5)).sum())
            s["misloc"] += int((keep & (best >= 0.1) & (best < 0.5)).sum())
            s["halluc"] += int((keep & (best < 0.1)).sum())
            s["hit_score_sum"] += float(scores[keep & (best >= 0.5)].sum())
            s["halluc_score_sum"] += float(scores[keep & (best < 0.1)].sum())
    for b, s in out.items():
        if s["n_images"] == 0:
            continue
        s["dets_per_img"] = round(s["dets"] / s["n_images"], 2)
        s["halluc_per_img"] = round(s["halluc"] / s["n_images"], 2)
        s["misloc_per_img"] = round(s["misloc"] / s["n_images"], 2)
        s["hits_per_img"] = round(s["hits"] / s["n_images"], 2)
        s["gt_recall@0.5"] = round(s["gt_recalled"] / max(s["gt_total"], 1),
                                   4)
        s["hit_score_mean"] = round(s["hit_score_sum"] / max(s["hits"], 1), 3)
        s["halluc_score_mean"] = round(
            s["halluc_score_sum"] / max(s["halluc"], 1), 3)
    return {b: s for b, s in out.items() if s["n_images"]}


def _zero():
    return {"n_images": 0, "gt_total": 0, "gt_recalled": 0, "dets": 0,
            "hits": 0, "misloc": 0, "halluc": 0, "hit_score_sum": 0.0,
            "halluc_score_sum": 0.0}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("run_dirs", nargs="+")
    p.add_argument("--ann", default=None,
                   help="val annotation json (enables polar/body strata)")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--out", default=None, help="write the JSON report here")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Prints a line a run and returns the report (run name -> buckets)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    strata = None
    if args.ann:
        with open(args.ann) as f:
            strata = {im["id"]: tuple(im.get("strata", ()))
                      for im in json.load(f)["images"]}
    report = {}
    for d in args.run_dirs:
        npz = os.path.join(d, "eval_arrays.npz")
        if not os.path.exists(npz):
            print(f"{d}: no eval_arrays.npz (re-run the study with "
                  f"ap_study)")
            continue
        name = os.path.basename(d.rstrip("/"))
        report[name] = diagnose(npz, args.score_thr, strata, device)
        s = report[name]["all"]
        print(f"{name}: dets/img={s['dets_per_img']} "
              f"hits={s['hits_per_img']} misloc={s['misloc_per_img']} "
              f"halluc={s['halluc_per_img']} recall@0.5={s['gt_recall@0.5']} "
              f"scores hit/halluc={s['hit_score_mean']}/"
              f"{s['halluc_score_mean']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()

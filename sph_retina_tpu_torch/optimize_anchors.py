"""Optimise anchor FoV shapes on a dataset.

    python -m sph_retina_tpu_torch.optimize_anchors CONFIG --algorithm k-means
    python -m sph_retina_tpu_torch.optimize_anchors CONFIG \\
        --algorithm differential_evolution --num-anchors 9 --iters 300 \\
        --output-dir anchor_opt/

Fits K (alpha, beta) FoV pairs to the ground-truth spherical boxes of the
config's ``data.train`` (``--synthetic``: 64 synthetic images) by
maximising their average best spherical IoU (``boxes/anchor_opt.py``),
and prints it beside the config's own anchors' ("before": their distinct
FoV pairs). The IoUs run on the CUDA device unless ``--device cpu`` is
given. ``--output-dir`` receives ``anchor_optimize_result.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .boxes.anchor_opt import evolve_anchors, kmeans_anchors, mean_best_iou
from .data import SphCocoDataset, make_synthetic_dataset
from .engine.zoo import get_family
from .utils.config import load_config
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Optimise anchor FoV shapes")
    p.add_argument("config")
    p.add_argument("--algorithm", default="differential_evolution",
                   choices=["k-means", "differential_evolution"])
    p.add_argument("--num-anchors", type=int, default=None,
                   help="K; default: the config's count of distinct base "
                        "anchor FoV pairs")
    p.add_argument("--iters", type=int, default=None,
                   help="k-means sweeps (default 25) or DE generations "
                        "(default 200)")
    p.add_argument("--backend", default="sph2pob_efficient")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="the in-memory synthetic dataset (smoke tests)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    return p.parse_args(argv)


def config_anchor_fovs(cfg: dict):
    """The distinct (alpha, beta) of the config's anchors, rounded to 0.01
    degree; ``None`` where the family has no anchors."""
    try:
        with torch.device("meta"):  # the detector config only, no weights
            _, det_cfg = get_family(cfg).build(cfg)
        anchors = det_cfg.flat_anchors(torch.device("cpu")).numpy()
    except Exception as e:
        print(f"(config anchors unavailable: {type(e).__name__}: {e})")
        return None
    return np.unique(np.round(anchors[:, 2:4], 2), axis=0)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    box_version = cfg["model"].get("box_version", 4)
    if args.synthetic:
        ds = make_synthetic_dataset(
            n_images=64, num_classes=cfg["model"]["num_classes"],
            box_version=box_version, seed=args.seed)
    else:
        d = cfg["data"]["train"]
        ds = SphCocoDataset(ann_file=d["ann_file"],
                            img_prefix=d.get("img_prefix", ""),
                            box_version=box_version)
    fovs = [it["boxes"][:, 2:4] for it in (ds[i] for i in range(len(ds)))
            if it["boxes"].shape[0]]
    gt_fovs = np.concatenate(fovs, axis=0)
    print(f"{gt_fovs.shape[0]} GT boxes from {len(ds)} images")

    base_fovs = config_anchor_fovs(cfg)
    k = args.num_anchors or (len(base_fovs) if base_fovs is not None else 9)
    if base_fovs is not None:
        before = mean_best_iou(gt_fovs, base_fovs, args.backend, device)
        print(f"config anchors: K={len(base_fovs)} avg best IoU = "
              f"{before:.4f}")

    if args.algorithm == "k-means":
        out = kmeans_anchors(gt_fovs, k, iters=args.iters or 25,
                             seed=args.seed, backend=args.backend,
                             device=device)
    else:
        out = evolve_anchors(gt_fovs, k, iters=args.iters or 200,
                             seed=args.seed, backend=args.backend,
                             device=device)
    after = mean_best_iou(gt_fovs, out, args.backend, device)
    print(f"optimized anchors ({args.algorithm}): K={k} "
          f"avg best IoU = {after:.4f}")
    for a, b in out:
        print(f"  alpha={a:7.2f}  beta={b:7.2f}")

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        path = os.path.join(args.output_dir, "anchor_optimize_result.json")
        with open(path, "w") as f:
            json.dump({"algorithm": args.algorithm, "backend": args.backend,
                       "avg_best_iou": after,
                       "anchors_alpha_beta_deg": out.tolist()}, f, indent=2)
        print(f"saved {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Per-class error-type decomposition plots (C75/C50/Loc/Oth/BG/FN).

    python -m sph_retina_tpu_torch.test cfg.py ckpts --save-raw raw.npz
    python -m sph_retina_tpu_torch.coco_error_analysis cfg.py raw.npz out_dir

Counterpart of the reference's ``coco_error_analysis.py``: stacked
precision / recall areas that show how much AP each error source costs,
all matching by spherical IoU (``engine/error_analysis.py``). Writes one
plot a class with ground truth, one over all classes, and
``error_analysis.json`` (the mean AP of each rung) into ``out_dir``. The
IoU matrices are computed on the CUDA device unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .engine.analysis import _unpack, load_raw_results
from .engine.error_analysis import (
    ERROR_TYPES,
    RECALL_LEVELS,
    error_decomposition,
)
from .utils.config import load_config
from .utils.device import resolve_device
from .visualize.canvas import BLACK, Axes

# the reference's colour ramp, one a band
COLORS = [(0.31, 0.51, 0.74), (0.75, 0.31, 0.30), (0.36, 0.90, 0.38),
          (0.50, 0.39, 0.64), (1.0, 0.6, 0.0), (0.8, 0.8, 0.8)]


def make_plot(ps_cls, ap_cls, title, out_file):
    """The error types' precision curves as stacked bands over recall, each
    labelled with its AP, the curves drawn over the bands."""
    ax = Axes(600, 480, (0.0, 1.0), (0.0, 1.0), title=title,
              xlabel="recall", ylabel="precision")
    prev = np.zeros_like(RECALL_LEVELS)
    for k, name in enumerate(ERROR_TYPES):
        ax.fill_between(RECALL_LEVELS, prev, ps_cls[k], COLORS[k],
                        label=f"[{ap_cls[k]:.3f}] {name}")
        prev = ps_cls[k]
    for k in range(len(ERROR_TYPES)):
        ax.line(RECALL_LEVELS, ps_cls[k], BLACK)
    ax.legend("lower left")
    ax.save(out_file)


def decompose(arrays: dict, num_classes: int, backend: str, max_dets: int,
              device) -> dict:
    """``error_decomposition`` of the raw result arrays."""
    dets, anns = [], []
    for i in range(arrays["boxes"].shape[0]):
        det_boxes, scores, det_labels, gt_boxes, gt_labels = _unpack(arrays, i)
        dets.append((det_boxes, scores, det_labels))
        anns.append({"boxes": gt_boxes, "labels": gt_labels})
    return error_decomposition(dets, anns, num_classes, backend=backend,
                               max_dets=max_dets, device=device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Error-type decomposition")
    p.add_argument("config")
    p.add_argument("raw_results", help="npz from test.py --save-raw")
    p.add_argument("out_dir")
    p.add_argument("--backend", default="unbiased")
    p.add_argument("--max-dets", type=int, default=100)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    num_classes = cfg["model"]["num_classes"]
    out = decompose(load_raw_results(args.raw_results), num_classes,
                    args.backend, args.max_dets, device)
    os.makedirs(args.out_dir, exist_ok=True)

    names = cfg.get("classes") or [f"class_{c}" for c in range(num_classes)]
    for c in np.where(out["valid"])[0]:
        make_plot(out["ps"][:, :, c], out["ap"][:, c],
                  f"bbox-{names[c]}-allarea",
                  os.path.join(args.out_dir, f"bbox-{names[c]}-allarea.png"))
    mean_ps = out["ps"][:, :, out["valid"]].mean(axis=2)
    mean_ap = out["ap"][:, out["valid"]].mean(axis=1)
    make_plot(mean_ps, mean_ap, "bbox-allclass-allarea",
              os.path.join(args.out_dir, "bbox-allclass-allarea.png"))

    summary = {name: float(v) for name, v in zip(ERROR_TYPES, mean_ap)}
    with open(os.path.join(args.out_dir, "error_analysis.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("mean AP per error rung:",
          " ".join(f"{k}={v:.3f}" for k, v in summary.items()))
    print(f"wrote {int(out['valid'].sum()) + 1} plots to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""IoU-matched confusion matrix from raw detection results.

    python -m sph_retina_tpu_torch.test cfg.py ckpts --save-raw raw.npz
    python -m sph_retina_tpu_torch.confusion_matrix cfg.py raw.npz out_dir \\
        --score-thr 0.3 --tp-iou-thr 0.5

Counterpart of the reference's ``confusion_matrix.py`` (there: a pickle of
results and the dataset; here: the ``.npz`` of ``test.py --save-raw``),
with spherical-IoU matching (``engine/analysis.py``). Writes
``confusion_matrix.npy`` and ``confusion_matrix.png`` into ``out_dir``.
The IoU matrices are computed on the CUDA device unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .engine.analysis import confusion_matrix, load_raw_results
from .utils.config import load_config
from .utils.device import resolve_device
from .visualize.canvas import WHITE, Axes


def plot_confusion_matrix(cm, class_names, out_file, normalize=True,
                          title="Normalized Confusion Matrix"):
    """The ``Blues`` heat map of the matrix (rows normalised to percent
    where ``normalize``), one square cell a class pair, each non-zero cell
    with its value, and a colorbar."""
    mat = cm.astype(np.float64)
    if normalize:
        row = mat.sum(axis=1, keepdims=True)
        mat = mat / np.maximum(row, 1) * 100.0
    n = len(class_names)
    cell = max(12, min(40, 960 // max(n, 1)))
    vmax = mat.max() if mat.size else 0.0
    ax = Axes(cell * n, cell * n, (-0.5, n - 0.5), (n - 0.5, -0.5),
              title=title, xlabel="Prediction", ylabel="Ground truth")
    ax.image(mat, cmap="Blues", vmin=0.0, vmax=vmax)
    ax.colorbar("Blues", 0.0, vmax)
    ax.set_xticks(range(n), class_names, rotation=90)
    ax.set_yticks(range(n), class_names)
    thresh = vmax / 2
    for i in range(n):
        for j in range(n):
            val = mat[i, j]
            if val > 0:
                ax.text(j, i, f"{val:.0f}",
                        color=WHITE if val > thresh else (0, 0, 0))
    ax.save(out_file)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Confusion matrix of raw results")
    p.add_argument("config")
    p.add_argument("raw", help="npz from test.py --save-raw")
    p.add_argument("out_dir")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--tp-iou-thr", type=float, default=0.5)
    p.add_argument("--iou-backend", default="sph2pob_efficient")
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    nc = load_config(args.config)["model"]["num_classes"]
    cm = confusion_matrix(load_raw_results(args.raw), nc,
                          score_thr=args.score_thr, iou_thr=args.tp_iou_thr,
                          backend=args.iou_backend, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "confusion_matrix.npy"), cm)
    names = [f"class_{i}" for i in range(nc)] + ["background"]
    plot_confusion_matrix(cm, names,
                          os.path.join(args.out_dir, "confusion_matrix.png"),
                          normalize=not args.no_normalize)
    diag = np.trace(cm[:nc, :nc])
    total = cm[:nc].sum()
    print(f"matched GT: {diag}/{total} "
          f"({100.0 * diag / max(total, 1):.1f}% on-diagonal)")
    print(f"saved to {args.out_dir}/confusion_matrix.{{npy,png}}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

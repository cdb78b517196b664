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


def plot_confusion_matrix(cm, class_names, out_file, normalize=True,
                          title="Normalized Confusion Matrix"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mat = cm.astype(np.float64)
    if normalize:
        row = mat.sum(axis=1, keepdims=True)
        mat = mat / np.maximum(row, 1) * 100.0
    n = len(class_names)
    fig, ax = plt.subplots(figsize=(0.5 * n + 4, 0.5 * n + 3))
    im = ax.imshow(mat, cmap=plt.get_cmap("Blues"))
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(class_names, rotation=45, ha="right", fontsize=8)
    ax.set_yticklabels(class_names, fontsize=8)
    ax.set_xlabel("Prediction")
    ax.set_ylabel("Ground truth")
    ax.set_title(title)
    thresh = mat.max() / 2 if mat.size else 0
    for i in range(n):
        for j in range(n):
            val = mat[i, j]
            if val > 0:
                ax.text(j, i, f"{val:.0f}", ha="center", va="center",
                        fontsize=7,
                        color="white" if val > thresh else "black")
    fig.tight_layout()
    fig.savefig(out_file, dpi=150)
    plt.close(fig)


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

"""Rank predictions per image and save the best / worst visualizations.

    python -m sph_retina_tpu_torch.analyze_results cfg.py raw.npz out_dir \\
        --topk 5
    python -m sph_retina_tpu_torch.analyze_results cfg.py raw1.npz out_dir \\
        --compare raw2.npz --topk 5

Counterpart of the reference's ``analyze_results.py`` (per-image mAP
ranking, top-k "good" and "bad" galleries) and of its two-model comparison
(``--compare``: images ranked by the per-image mAP difference, both
models' predictions saved for the most improved and regressed images). On
the ``.npz`` of ``test.py --save-raw``; the images are read again through
the config's ``data.test`` set, ground truth drawn green, predictions red
(the second model's blue). The IoU matrices are computed on the CUDA
device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .data import SphCocoDataset, SphPipeline
from .engine.analysis import load_raw_results, per_image_scores
from .utils.config import load_config
from .utils.device import resolve_device
from .visualize.sph_draw import draw_boxes


def _render(pipe, ds, by_id, arrays, i, score_thr, color=(230, 30, 30)):
    """The dataset's image of row ``i`` of ``arrays``, ground truth green
    and the row's predictions above ``score_thr`` in ``color``; None where
    the dataset has no such image id."""
    img_id = int(arrays["img_id"][i])
    if img_id not in by_id:
        return None
    item = ds[by_id[img_id]]
    img = pipe.resize(pipe.load_image(item["img_path"])).copy()
    img = draw_boxes(img, item["boxes"], labels=item["labels"],
                     color=(0, 220, 0))
    v = arrays["valid"][i].astype(bool) & (arrays["scores"][i] >= score_thr)
    return draw_boxes(img, arrays["boxes"][i][v],
                      labels=arrays["labels"][i][v].astype(int),
                      scores=arrays["scores"][i][v], color=color)


def _save(img, out_dir, name):
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    Image.fromarray(img).save(os.path.join(out_dir, name))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Per-image result galleries")
    p.add_argument("config")
    p.add_argument("raw", help="npz from test.py --save-raw")
    p.add_argument("out_dir")
    p.add_argument("--compare", default=None, metavar="RAW2",
                   help="second --save-raw npz; rank images by the "
                        "per-image mAP difference (model1 - model2)")
    p.add_argument("--topk", type=int, default=20)
    p.add_argument("--show-score-thr", type=float, default=0.3)
    p.add_argument("--iou-backend", default="sph2pob_efficient")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    nc = cfg["model"]["num_classes"]
    arrays = load_raw_results(args.raw)
    scores = per_image_scores(arrays, nc, backend=args.iou_backend,
                              device=device)

    d = cfg["data"]["test"]
    ds = SphCocoDataset(ann_file=d["ann_file"],
                        img_prefix=d.get("img_prefix", ""),
                        box_version=cfg["model"].get("box_version", 4))
    by_id = {int(ds[i]["img_id"]): i for i in range(len(ds))}
    pipe = SphPipeline(img_size=tuple(cfg.get("img_size", (512, 1024))),
                       training=False)

    if args.compare is None:
        order = np.argsort(scores)
        picks = [("bad", order[: args.topk]),
                 ("good", order[-args.topk:][::-1])]
        for kind, idxs in picks:
            out = os.path.join(args.out_dir, kind)
            n = 0
            for rank, i in enumerate(idxs):
                img = _render(pipe, ds, by_id, arrays, i,
                              args.show_score_thr)
                if img is None:
                    continue
                img_id = int(arrays["img_id"][i])
                _save(img, out,
                      f"{rank:02d}_map{scores[i]:.3f}_img{img_id}.png")
                n += 1
            print(f"{kind}: {n} images -> {out}")
        print(f"per-image mAP: mean={scores.mean():.4f} "
              f"min={scores.min():.4f} max={scores.max():.4f}")
        return 0

    # two models: align the raw result sets by img_id, rank by the per-image
    # mAP difference, save both models' predictions for the extremes
    arrays2 = load_raw_results(args.compare)
    scores2 = per_image_scores(arrays2, nc, backend=args.iou_backend,
                               device=device)
    row2 = {int(arrays2["img_id"][j]): j
            for j in range(arrays2["img_id"].shape[0])}
    pairs = [(i, row2[int(img_id)]) for i, img_id in enumerate(
        arrays["img_id"]) if int(img_id) in row2]
    if not pairs:
        raise SystemExit("no common img_ids between the two raw files")
    deltas = np.array([scores[i] - scores2[j] for i, j in pairs])
    order = np.argsort(deltas)
    picks = [("model2_better", order[: args.topk]),
             ("model1_better", order[-args.topk:][::-1])]
    for kind, ks in picks:
        out = os.path.join(args.out_dir, kind)
        n = 0
        for rank, k in enumerate(ks):
            i, j = pairs[k]
            img_id = int(arrays["img_id"][i])
            stem = f"{rank:02d}_dmap{deltas[k]:+.3f}_img{img_id}"
            im1 = _render(pipe, ds, by_id, arrays, i, args.show_score_thr)
            im2 = _render(pipe, ds, by_id, arrays2, j, args.show_score_thr,
                          color=(40, 90, 235))
            if im1 is None or im2 is None:
                continue
            _save(im1, out, stem + "_m1.png")
            _save(im2, out, stem + "_m2.png")
            n += 1
        print(f"{kind}: {n} images -> {out}")
    print(f"per-image mAP delta (m1-m2): mean={deltas.mean():+.4f} "
          f"min={deltas.min():+.4f} max={deltas.max():+.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

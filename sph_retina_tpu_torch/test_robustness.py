"""Corruption-robustness benchmark of a detector checkpoint.

    python -m sph_retina_tpu_torch.test_robustness CONFIG CHECKPOINT \\
        --corruptions benchmark --severities 0 1 2 3 4 5 --out robust.json

Evaluates the checkpoint (a checkpoint directory or one ``epoch_N`` file,
as ``test.py`` takes it) on the config's ``data.test`` split
(``--synthetic``: ``--n-images`` synthetic images) clean and under each
corruption of ``data/corruptions.py`` at each severity, seeded by
``--seed``, with COCO-style spherical AP (``engine/evaluator.py``). The
corruptions run on the host in PyTorch and need no OpenCV; the detector,
its NMS and the matcher's IoUs run on the CUDA device unless ``--device
cpu`` is given. ``--corruptions benchmark`` is all 15 in the benchmark's
order. Writes the JAX package's nested JSON: ``"clean" -> {"0":
metrics}`` once, then ``name -> {str(severity): metrics}`` (float metrics
only), which ``robustness_eval`` turns into P / mPC / rPC.
"""

from __future__ import annotations

import argparse
import json
import sys

from .data import DataLoader, SphPipeline, make_synthetic_dataset
from .data.corruptions import BENCHMARK_CORRUPTIONS, CorruptedDataset
from .engine.builder import build_datasets
from .engine.evaluator import evaluate_dataset
from .engine.zoo import get_family
from .test import load_for_eval
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Corruption-robustness benchmark")
    p.add_argument("config")
    p.add_argument("checkpoint",
                   help="checkpoint directory or one epoch_N file")
    p.add_argument("--corruptions", nargs="+", default=["benchmark"],
                   help="'benchmark' = every implemented corruption")
    p.add_argument("--severities", nargs="+", type=int,
                   default=[0, 1, 2, 3, 4, 5])
    p.add_argument("--iou-backend", default="sph2pob_efficient")
    p.add_argument("--out", default="robustness_results.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--n-images", type=int, default=16,
                   help="synthetic dataset size")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    img_size = tuple(cfg.get("img_size", (512, 1024)))
    box_version = cfg["model"].get("box_version", 4)
    if args.synthetic:
        base_ds = make_synthetic_dataset(
            n_images=args.n_images, num_classes=cfg["model"]["num_classes"],
            img_size=img_size, box_version=box_version)
    else:
        base_ds, _ = build_datasets(cfg, "test")
    pipe = SphPipeline(img_size=img_size, training=False,
                       box_version=box_version)
    model, det_cfg, step = load_for_eval(cfg, args.checkpoint, device)
    print(f"loaded checkpoint at step {step}")
    predict = get_family(cfg).predict_fn(model, det_cfg)

    names = list(BENCHMARK_CORRUPTIONS) \
        if "benchmark" in args.corruptions else args.corruptions
    results: dict = {}
    for name in names:
        for sev in sorted(set(args.severities)):
            if sev == 0 and "clean" in results:
                continue
            ds = (base_ds if sev == 0 else
                  CorruptedDataset(base_ds, name, sev, seed=args.seed))
            loader = DataLoader(ds, pipe, batch_size=4, shuffle=False,
                                drop_last=False)
            r = evaluate_dataset(model, det_cfg, loader,
                                 backend=args.iou_backend, predict=predict)
            summary = {k: v for k, v in r.items() if isinstance(v, float)}
            key = "clean" if sev == 0 else name
            results.setdefault(key, {})[str(sev)] = summary
            print(f"{key} severity={sev}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in summary.items()))

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

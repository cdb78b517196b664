"""Evaluate an exported artifact over a dataset.

    python -m sph_retina_tpu_torch.deployment_test CONFIG ARTIFACT \
        [--eval bbox] [--iou-backend B] [--out res.json] [--synthetic] \
        [--device cpu] [--cfg-options ...]

The twin of the JAX package's ``tools/deployment_test.py``. The artifact
(``export_model.py``: the whole predict path with the weights in it) runs
over the config's ``data.test`` split — ``--synthetic``: 16 synthetic
images — and is scored with the spherical-IoU COCO-style mAP of
``test.py``, so the numbers compare with ``test.py`` on the source weights.
The batch size and ``img_size`` come from the artifact's input spec; a
config of another ``img_size`` is refused, and a ragged last batch is padded
up and sliced back. Batches the loader yields as uint8 are normalised on the
device first. The float metrics are printed as JSON and written to
``--out``. Runs on the CUDA device unless ``--device cpu`` is given; the
artifact must have been exported on that device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .boxes.nms import NMSResult
from .data import DataLoader, SphPipeline, make_synthetic_dataset
from .data.pipeline import maybe_normalize_images
from .engine.builder import build_datasets
from .engine.evaluator import evaluate_dataset
from .engine.zoo import get_family
from .export import artifact_meta, load_exported
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate an exported artifact")
    p.add_argument("config")
    p.add_argument("artifact", help="artifact file of export_model")
    p.add_argument("--eval", default="bbox", choices=["bbox"])
    p.add_argument("--iou-backend", default="sph2pob_efficient",
                   help="spherical IoU backend used for det-gt matching")
    p.add_argument("--out", default=None, help="write results JSON here")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device; cpu for smoke tests")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    with open(args.artifact, "rb") as f:
        data = f.read()
    meta = artifact_meta(data)
    if meta["device"] != device.type:
        raise SystemExit(f"the artifact runs on {meta['device']!r}, not on "
                         f"{device.type!r}")
    batch_size, h, w, _ = meta["input_shape"]
    img_size = tuple(cfg.get("img_size", (512, 1024)))
    if (h, w) != img_size:
        raise SystemExit(f"artifact was exported at img_size {(h, w)} but "
                         f"the config says {img_size}")
    call = load_exported(data)
    # the detector config, for the matcher's classes; the weights are the
    # artifact's
    model, det_cfg = get_family(cfg).build(cfg)

    if args.synthetic:
        box_version = cfg["model"].get("box_version", 4)
        ds = make_synthetic_dataset(
            n_images=16, num_classes=cfg["model"]["num_classes"],
            img_size=img_size, box_version=box_version)
        pipe = SphPipeline(img_size=img_size, training=False,
                           box_version=box_version)
        loader = DataLoader(ds, pipe, batch_size=batch_size, shuffle=False,
                            drop_last=False)
    else:
        # the loader must batch at the artifact's batch size
        cfg.setdefault("data", {})["samples_per_gpu"] = batch_size
        _, loader = build_datasets(cfg, "test")

    def predict(images: torch.Tensor) -> NMSResult:
        images = maybe_normalize_images(images.to(device))
        n = images.shape[0]
        if n < batch_size:
            images = torch.cat([images, images.new_zeros(
                (batch_size - n, *images.shape[1:]))])
        return NMSResult(*(o[:n] for o in call(images)))

    results = evaluate_dataset(model, det_cfg, loader,
                               backend=args.iou_backend, predict=predict,
                               device=device)
    summary = {k: v for k, v in results.items() if isinstance(v, float)}
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

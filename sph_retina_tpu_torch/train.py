"""Train a spherical detector.

    python -m sph_retina_tpu_torch.train \\
        configs/sph_rotated_retinanet_r50_fpn_120e_pandora.py \\
        --work-dir work_dirs/rotated_pandora \\
        --cfg-options optimizer.lr=0.01 data.samples_per_gpu=8

``--synthetic`` trains on an in-memory synthetic dataset (smoke testing
without data on disk). Runs on the CUDA device unless ``--device cpu`` is
given; without a card it raises instead of carrying on on the CPU. Metrics
go to ``<work-dir>/metrics.jsonl``.

Not available in this package yet, and raising ``NotImplementedError`` by
name when asked for: training on an annotation file (the COCO-style dataset
reader), ``--resume-from`` / ``--auto-resume`` (checkpoints), ``--launcher``
(multi-process data parallelism), ``--load-backbone``, and the periodic
evaluation and checkpoints that a config's ``evaluation`` and
``checkpoint_config`` keys ask for (both are skipped, with a note printed).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from .data import DataLoader, SphPipeline, make_synthetic_dataset, to_device
from .engine.builder import build_tx
from .engine.runner import MetricLogger, run_training
from .engine.zoo import get_family, make_generic_train_step
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a spherical detector")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use an in-memory synthetic dataset")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device; cpu for smoke tests")
    p.add_argument("--load-backbone", default=None, metavar="PATH")
    p.add_argument("--launcher", default="none", choices=["none", "torch"])
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def build_training(cfg: dict, device: torch.device, seed: int = 0):
    """(model, detector config, loader, optimiser, train step) for a config
    dict on the synthetic dataset: what ``main`` runs, for callers that drive
    the steps themselves."""
    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device)

    data = cfg.get("data", {})
    img_size = tuple(cfg.get("img_size", (512, 1024)))
    box_version = cfg["model"].get("box_version", 4)
    ds = make_synthetic_dataset(
        n_images=data.get("n_synthetic", 32),
        num_classes=cfg["model"]["num_classes"],
        img_size=img_size, box_version=box_version)
    pipe = SphPipeline(img_size=img_size, max_gt=data.get("max_gt", 64),
                       box_version=box_version)
    loader = DataLoader(ds, pipe, batch_size=data.get("samples_per_gpu", 4),
                        seed=seed, aug_seed=cfg.get("aug_seed"))
    optimizer = build_tx(cfg, model, steps_per_epoch=max(len(loader), 1))
    step = make_generic_train_step(family, model, det_cfg, optimizer,
                                   seed=seed)
    return model, det_cfg, loader, optimizer, step


def main(argv=None) -> int:
    args = parse_args(argv)
    for flag, value in (("--resume-from", args.resume_from),
                        ("--auto-resume", args.auto_resume),
                        ("--load-backbone", args.load_backbone)):
        if value:
            raise NotImplementedError(
                f"{flag} is not available in this package yet")
    if args.launcher != "none":
        raise NotImplementedError(
            f"--launcher {args.launcher} is not available in this package yet")
    if not args.synthetic:
        raise NotImplementedError(
            "training on an annotation file is not available in this package "
            "yet (no dataset reader); pass --synthetic")
    device = resolve_device(args.device)

    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)

    _, _, loader, optimizer, step = build_training(cfg, device, args.seed)
    max_epochs = args.max_epochs or cfg.get("runner", {}).get("max_epochs", 120)
    print(f"device: {device}; steps/epoch: {len(loader)}; "
          f"trainable tensors: {len(optimizer.params)}, "
          f"frozen: {len(optimizer.frozen_names)}")
    for key in ("evaluation", "checkpoint_config"):
        if cfg.get(key):
            print(f"note: config key {key!r} is skipped (not available in "
                  "this package yet)")

    log_cfg = cfg.get("log_config", {})
    logger = MetricLogger(work_dir, interval=log_cfg.get("interval", 10),
                          wandb_init=log_cfg.get("wandb", None))
    try:
        run_training(
            train_step=step,
            optimizer=optimizer,
            loader=loader,
            max_epochs=max_epochs,
            logger=logger,
            transfer=lambda b: to_device(
                {k: v for k, v in b.items() if k != "img_id"}, device),
        )
    finally:
        logger.close()
    print("training done")
    return 0


if __name__ == "__main__":
    sys.exit(main())

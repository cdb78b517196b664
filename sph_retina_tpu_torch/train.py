"""Train a spherical detector.

    python -m sph_retina_tpu_torch.train \\
        configs/sph_rotated_retinanet_r50_fpn_120e_pandora.py \\
        --work-dir work_dirs/rotated_pandora \\
        --cfg-options optimizer.lr=0.01 data.samples_per_gpu=8

Trains on the config's COCO-style annotation files (``data.train``,
evaluated on ``data.val``); ``--synthetic`` trains on an in-memory synthetic
dataset instead (smoke testing without data on disk), evaluated on the same
images. Runs on the CUDA device unless ``--device cpu`` is given; without a
card it raises instead of carrying on on the CPU.

Metrics go to ``<work-dir>/metrics.jsonl``. Every ``evaluation.interval``
epochs the model is evaluated (COCO-style spherical AP, logged with prefix
``val``); every ``checkpoint_config.interval`` epochs and after the last one
a checkpoint is written to ``<work-dir>/ckpts/epoch_N`` (and ``best`` when
AP50 improves). ``--auto-resume`` continues from the newest checkpoint
there, ``--resume-from PATH`` from a given one (a checkpoint file or
directory): the model, the optimiser and the train step's generator are
restored, and training goes on at the next step.

Not available in this package yet, and raising ``NotImplementedError`` by
name when asked for: ``--launcher`` (multi-process data parallelism) and
``--load-backbone``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from .data import DataLoader, SphPipeline, make_synthetic_dataset, to_device
from .data.loader import PinnedStaging
from .engine.builder import build_datasets, build_tx
from .engine.evaluator import evaluate_dataset
from .engine.runner import Checkpointer, MetricLogger, run_training
from .engine.zoo import get_family, make_generic_train_step
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device
from .utils.env import env_string


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


def synthetic_loaders(cfg: dict, seed: int = 0):
    """(train loader, val loader) over the synthetic dataset: the val loader
    takes the same images, unshuffled, keeping the last partial batch."""
    data = cfg.get("data", {})
    img_size = tuple(cfg.get("img_size", (512, 1024)))
    box_version = cfg["model"].get("box_version", 4)
    ds = make_synthetic_dataset(
        n_images=data.get("n_synthetic", 32),
        num_classes=cfg["model"]["num_classes"],
        img_size=img_size, box_version=box_version)
    pipe = SphPipeline(img_size=img_size, max_gt=data.get("max_gt", 64),
                       box_version=box_version)
    bs = data.get("samples_per_gpu", 4)
    loader = DataLoader(ds, pipe, batch_size=bs, seed=seed,
                        aug_seed=cfg.get("aug_seed"))
    val_loader = DataLoader(ds, pipe, batch_size=bs, shuffle=False,
                            drop_last=False, seed=seed)
    return loader, val_loader


def annotation_loaders(cfg: dict):
    """(train loader, val loader) of the config's annotation files; a model
    whose ``num_classes`` is not the dataset's raises (mmdet's
    NumClassCheckHook)."""
    ds, loader = build_datasets(cfg, "train")
    _, val_loader = build_datasets(cfg, "val")
    if ds.num_classes != cfg["model"]["num_classes"]:
        raise ValueError(
            f"model.num_classes={cfg['model']['num_classes']} but the "
            f"dataset {ds.ann_file} has {ds.num_classes} categories")
    return loader, val_loader


def build_training(cfg: dict, device: torch.device, seed: int = 0,
                   loader=None):
    """(model, detector config, loader, optimiser, train step) for a config
    dict: what ``main`` runs, for callers that drive the steps themselves.
    ``loader`` defaults to the synthetic dataset's."""
    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device)
    if loader is None:
        loader, _ = synthetic_loaders(cfg, seed)
    optimizer = build_tx(cfg, model, steps_per_epoch=max(len(loader), 1))
    step = make_generic_train_step(family, model, det_cfg, optimizer,
                                   seed=seed)
    return model, det_cfg, loader, optimizer, step


def memory_interval(cfg: dict) -> int | None:
    """A MemoryProfiler custom hook's interval, else ``memory_interval``."""
    return next((h.get("interval", 50)
                 for h in (cfg.get("custom_hooks") or [])
                 if isinstance(h, dict)
                 and "MemoryProfiler" in str(h.get("type", ""))),
                cfg.get("memory_interval"))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.load_backbone:
        raise NotImplementedError(
            "--load-backbone is not available in this package yet")
    if args.launcher != "none":
        raise NotImplementedError(
            f"--launcher {args.launcher} is not available in this package yet")
    device = resolve_device(args.device)

    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    cfg.setdefault("seed", args.seed)
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)

    if args.synthetic:
        loader, val_loader = synthetic_loaders(cfg, args.seed)
    else:
        loader, val_loader = annotation_loaders(cfg)
    model, det_cfg, loader, optimizer, step = build_training(
        cfg, device, args.seed, loader)
    ckpt = Checkpointer(os.path.join(work_dir, "ckpts"))
    if args.resume_from or args.auto_resume:
        resumed = ckpt.restore(model, optimizer, args.resume_from,
                               generator=step.generator)
        print(f"resumed from step {resumed}")
    max_epochs = args.max_epochs or cfg.get("runner", {}).get("max_epochs", 120)
    print(f"device: {device}; steps/epoch: {len(loader)}; "
          f"trainable tensors: {len(optimizer.params)}, "
          f"frozen: {len(optimizer.frozen_names)}")
    print(env_string())  # collect_env parity: log the environment

    predict = get_family(cfg).predict_fn(model, det_cfg)

    def eval_fn():
        return {k: v for k, v in evaluate_dataset(
            model, det_cfg, val_loader, predict=predict).items()
            if isinstance(v, (int, float))}

    staging = PinnedStaging() if device.type == "cuda" else None
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
            checkpointer=ckpt,
            ckpt_interval=(cfg.get("checkpoint_config") or {}).get(
                "interval", 25),
            eval_fn=eval_fn if cfg.get("evaluation") else None,
            eval_interval=(cfg.get("evaluation") or {}).get("interval", 5),
            transfer=lambda b: to_device(
                {k: v for k, v in b.items() if k != "img_id"}, device,
                staging),
            memory_interval=memory_interval(cfg),
            model=model,
            device=device,
        )
    finally:
        logger.close()
    print("training done")
    return 0

if __name__ == "__main__":
    sys.exit(main())

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

``--load-backbone PATH`` starts the backbone from a torchvision checkpoint
(``torchvision://resnet50`` in the reference's configs): a ResNet of the
config's depth, or VGG16 for an SSD config; the optimiser and the EMA
shadow start from the loaded weights, and a resume overrides them.

Several processes, one a device, train as one (data parallelism)::

    torchrun --nproc_per_node N -m sph_retina_tpu_torch.train CONFIG \
        --launcher torch [--diff-seed]

``--launcher torch`` joins the group of the processes ``torchrun`` started
(NCCL on the card, gloo with ``--device cpu``; a group the caller already
set up is taken as it is). Each rank reads its shard of the train and val
sets, the parameters start from rank 0's, each loss is normalised by counts
over the global batch of ``N * samples_per_gpu`` images and the gradients
are summed over the ranks before the update, so that every rank takes the
global batch's step; the evaluation gathers every rank's results, and rank
0 alone logs and writes checkpoints. ``--diff-seed`` gives each rank its own
augmentation stream (``seed + rank``); the shuffle stays shared.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch
import torch.distributed as dist

from .data import DataLoader, SphPipeline, make_synthetic_dataset, to_device
from .data.loader import PinnedStaging
from .engine.builder import build_datasets, build_tx
from .engine.evaluator import evaluate_dataset
from .engine.runner import (
    Checkpointer,
    MetricLogger,
    RankZeroCheckpointer,
    run_training,
)
from .engine.zoo import get_family, make_generic_train_step
from .models.port import load_backbone
from .parallel import broadcast_parameters, get_world_size, process_group
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
    p.add_argument("--load-backbone", default=None, metavar="PATH",
                   help="torch checkpoint (torchvision layout) ported onto "
                        "the backbone before training")
    p.add_argument("--launcher", default="none", choices=["none", "torch"],
                   help="torch: join the group of the processes torchrun "
                        "started (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, "
                        "RANK, LOCAL_RANK)")
    p.add_argument("--diff-seed", action="store_true",
                   help="a different augmentation stream a rank (seed + "
                        "rank); the shuffle, the initialisation and the "
                        "train step's generator are seeded alike")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def synthetic_loaders(cfg: dict, seed: int = 0, num_shards: int = 1,
                      shard_id: int = 0):
    """(train loader, val loader) over the synthetic dataset: the val loader
    takes the same images, unshuffled, keeping the last partial batch; both
    read shard ``shard_id`` of ``num_shards``."""
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
                        aug_seed=cfg.get("aug_seed"), num_shards=num_shards,
                        shard_id=shard_id)
    val_loader = DataLoader(ds, pipe, batch_size=bs, shuffle=False,
                            drop_last=False, seed=seed, num_shards=num_shards,
                            shard_id=shard_id)
    return loader, val_loader


def annotation_loaders(cfg: dict, num_shards: int = 1, shard_id: int = 0):
    """(train loader, val loader) of the config's annotation files, shard
    ``shard_id`` of ``num_shards`` each; a model whose ``num_classes`` is
    not the dataset's raises (mmdet's NumClassCheckHook)."""
    ds, loader = build_datasets(cfg, "train", num_shards, shard_id)
    _, val_loader = build_datasets(cfg, "val", num_shards, shard_id)
    if ds.num_classes != cfg["model"]["num_classes"]:
        raise ValueError(
            f"model.num_classes={cfg['model']['num_classes']} but the "
            f"dataset {ds.ann_file} has {ds.num_classes} categories")
    return loader, val_loader


def backbone_arch(cfg: dict) -> str:
    """The torchvision architecture of the config's backbone: its ``arch``,
    else ``vgg16`` for an SSD, else ``resnet<depth>``."""
    model = cfg["model"]
    return model.get("backbone", {}).get("arch") or (
        "vgg16" if model.get("type", "").endswith("SSD")
        else f"resnet{model.get('backbone', {}).get('depth', 50)}")


def build_training(cfg: dict, device: torch.device, seed: int = 0,
                   loader=None, backbone: str | None = None):
    """(model, detector config, loader, optimiser, train step) for a config
    dict: what ``main`` runs, for callers that drive the steps themselves.
    ``loader`` defaults to the synthetic dataset's. ``backbone``: a torch
    checkpoint loaded into the backbone after the initialisation, before
    the optimiser takes its copies. In a process group the parameters are
    rank 0's (a broadcast, before the optimiser's copies) and the learning
    rate is scaled for the global batch (``auto_scale_lr``)."""
    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    if backbone:
        arch = backbone_arch(cfg)
        load_backbone(model, backbone, arch=arch)
        print(f"loaded {arch} backbone from {backbone}")
    model = model.to(device)
    broadcast_parameters(model)
    if loader is None:
        loader, _ = synthetic_loaders(cfg, seed)
    optimizer = build_tx(cfg, model, steps_per_epoch=max(len(loader), 1),
                         num_processes=get_world_size())
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
    device = resolve_device(args.device)
    with process_group(args.launcher, device) as (rank, world):
        return _train(args, device, rank, world)


def _train(args, device: torch.device, rank: int, world: int) -> int:
    cfg = apply_overrides(load_config(args.config), args.cfg_options)
    cfg.setdefault("seed", args.seed)
    if args.diff_seed:
        cfg["aug_seed"] = args.seed + rank
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)

    if args.synthetic:
        loader, val_loader = synthetic_loaders(cfg, args.seed, world, rank)
    else:
        loader, val_loader = annotation_loaders(cfg, world, rank)
    model, det_cfg, loader, optimizer, step = build_training(
        cfg, device, args.seed, loader, args.load_backbone)
    ckpt = (RankZeroCheckpointer if world > 1 else Checkpointer)(
        os.path.join(work_dir, "ckpts"))
    if args.resume_from or args.auto_resume:
        resumed = ckpt.restore(model, optimizer, args.resume_from,
                               generator=step.generator)
        print(f"resumed from step {resumed}")
    max_epochs = args.max_epochs or cfg.get("runner", {}).get("max_epochs", 120)
    backend = dist.get_backend() if dist.is_initialized() else "none"
    print(f"process {rank}/{world}; backend: {backend}; device: {device}; "
          f"steps/epoch: {len(loader)}; "
          f"trainable tensors: {len(optimizer.params)}, "
          f"frozen: {len(optimizer.frozen_names)}")
    if rank == 0:
        print(env_string())  # collect_env parity: log the environment

    predict = get_family(cfg).predict_fn(model, det_cfg)

    def eval_fn():
        return {k: v for k, v in evaluate_dataset(
            model, det_cfg, val_loader, predict=predict,
            distributed=world > 1).items()
            if isinstance(v, (int, float))}

    staging = PinnedStaging() if device.type == "cuda" else None
    log_cfg = cfg.get("log_config", {})
    logger = MetricLogger(work_dir, interval=log_cfg.get("interval", 10),
                          enabled=rank == 0,
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

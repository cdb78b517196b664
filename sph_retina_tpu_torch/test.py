"""Evaluate a trained spherical detector checkpoint.

    python -m sph_retina_tpu_torch.test CONFIG CHECKPOINT [--eval bbox]

``CHECKPOINT`` is a checkpoint directory (its newest checkpoint is taken, as
``--auto-resume`` takes it) or one ``epoch_N`` file of the trainer. The
config's ``data.test`` split is evaluated (``--synthetic``: 16 synthetic
images) with COCO-style spherical AP; the float metrics are printed as JSON
and written to ``--out``. ``--ema`` evaluates the EMA shadow weights of a
checkpoint trained with them. ``--save-raw NPZ`` writes the padded result
arrays an image (``engine/analysis.py``, the JAX package's layout), the
input of ``confusion_matrix``, ``coco_error_analysis``, ``occluded_recall``
and ``analyze_results``. Runs on the CUDA device unless ``--device cpu`` is
given.

``--launcher torch`` (under ``torchrun``, as for ``train.py``): each process
evaluates its shard of the set, the results are gathered to every process
and de-duplicated, and only rank 0 prints the metrics and writes ``--out``
and ``--save-raw``.
"""

from __future__ import annotations

import argparse
import json
import sys

from .data import DataLoader, SphPipeline, make_synthetic_dataset
from .engine.analysis import save_raw_results
from .engine.builder import build_datasets, build_tx
from .engine.evaluator import evaluate_dataset
from .engine.runner import load_checkpoint
from .engine.train import get_ema_params, with_ema_params
from .engine.zoo import get_family
from .parallel import process_group
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a detector checkpoint")
    p.add_argument("config")
    p.add_argument("checkpoint",
                   help="checkpoint directory or one epoch_N file")
    p.add_argument("--eval", default="bbox", choices=["bbox"])
    p.add_argument("--iou-backend", default="sph2pob_efficient",
                   help="spherical IoU backend used for det-gt matching")
    p.add_argument("--out", default=None, help="write results JSON here")
    p.add_argument("--save-raw", default=None, metavar="NPZ",
                   help="write the padded raw result arrays (input of the "
                        "analysis tools)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--ema", action="store_true",
                   help="evaluate with the EMA shadow weights")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device; cpu for smoke tests")
    p.add_argument("--launcher", default="none", choices=["none", "torch"],
                   help="torch: evaluate a shard a process of the group "
                        "torchrun started, and gather the results")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def eval_loader(cfg: dict, synthetic: bool, num_shards: int = 1,
                shard_id: int = 0):
    """Shard ``shard_id`` of ``num_shards`` of the config's ``data.test``, or
    of 16 synthetic images."""
    if not synthetic:
        return build_datasets(cfg, "test", num_shards, shard_id)[1]
    img_size = tuple(cfg.get("img_size", (512, 1024)))
    box_version = cfg["model"].get("box_version", 4)
    ds = make_synthetic_dataset(
        n_images=16, num_classes=cfg["model"]["num_classes"],
        img_size=img_size, box_version=box_version)
    pipe = SphPipeline(img_size=img_size, training=False,
                       box_version=box_version)
    return DataLoader(ds, pipe, batch_size=4, shuffle=False, drop_last=False,
                      num_shards=num_shards, shard_id=shard_id)


def load_for_eval(cfg: dict, checkpoint: str, device, ema: bool = False):
    """(model, detector config, step) of a checkpoint, on ``device``; with
    ``ema`` the EMA shadow weights (exits where the checkpoint has none)."""
    model, det_cfg = get_family(cfg).build(cfg)
    model = model.to(device)
    optimizer = build_tx(cfg, model, steps_per_epoch=1)
    step = load_checkpoint(checkpoint, model, optimizer)
    if ema:
        if get_ema_params(optimizer) is None:
            raise SystemExit("--ema: checkpoint has no EMA state "
                             "(train with ema_momentum / EMAHook)")
        with_ema_params(model, optimizer)
    return model, det_cfg, step


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    with process_group(args.launcher, device) as (rank, world):
        cfg = apply_overrides(load_config(args.config), args.cfg_options)
        loader = eval_loader(cfg, args.synthetic, world, rank)
        model, det_cfg, step = load_for_eval(cfg, args.checkpoint, device,
                                             args.ema)
        if rank == 0:
            print(f"loaded checkpoint at step {step}")
        results = evaluate_dataset(
            model, det_cfg, loader, backend=args.iou_backend,
            predict=get_family(cfg).predict_fn(model, det_cfg),
            distributed=world > 1, return_raw=bool(args.save_raw))
    if args.save_raw:
        results, raw = results
        if rank == 0:
            save_raw_results(args.save_raw, raw)
            print(f"raw results -> {args.save_raw}")
    summary = {k: v for k, v in results.items() if isinstance(v, float)}
    if rank == 0:
        print(json.dumps(summary, indent=2))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Strip a training checkpoint for publication.

    python -m sph_retina_tpu_torch.publish CONFIG CHECKPOINT OUT.npz [--ema]

Drops the optimiser state and writes the model's parameters and batch-norm
statistics as one compressed ``.npz`` in the JAX package's published layout
(``utils/publish.py``), its name suffixed with a hash of its content; both
packages' ``init_detector`` load it. ``CHECKPOINT`` is a checkpoint directory
(its newest checkpoint) or one ``epoch_N`` file; ``--ema`` publishes the EMA
shadow weights. Runs on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

from .models.from_flax import to_flax
from .test import load_for_eval
from .utils.config import load_config
from .utils.device import resolve_device
from .utils.publish import save_published


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Publish a detector checkpoint")
    p.add_argument("config")
    p.add_argument("checkpoint",
                   help="checkpoint directory or one epoch_N file")
    p.add_argument("out_file", help="output .npz path (the hash is appended)")
    p.add_argument("--ema", action="store_true",
                   help="publish the EMA shadow weights instead")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device; cpu for smoke tests")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    model, _, step = load_for_eval(cfg, args.checkpoint, device, args.ema)
    params, batch_stats = to_flax(model.state_dict())
    os.makedirs(os.path.dirname(os.path.abspath(args.out_file)), exist_ok=True)
    final = save_published(
        args.out_file, params, batch_stats,
        meta={"step": step, "config": os.path.basename(args.config),
              "ema": bool(args.ema)})
    print(f"published -> {final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

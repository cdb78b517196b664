"""Convert a reference-trained (mmdet-layout) RetinaNet checkpoint into a
published ``.npz`` that ``init_detector`` and ``test.py`` load.

    python -m sph_retina_tpu_torch.convert_reference_checkpoint \\
        ref_epoch_120.pth out.npz --depth 50

The reference's training artifacts are torch ``.pth`` files holding
``{"meta": ..., "state_dict": ...}`` (mmcv's format). The state dict is
mapped onto the port's module names (``models/port_mmdet.py``), turned into
the Flax layout (``models/from_flax.py:to_flax``) and written as the JAX
package's published file (``utils/publish.py``), hash-suffixed, with
``meta`` ``{"source": <file name>, "epoch": <the checkpoint's>}``: either
package's ``init_detector`` reads it. Host only, no device.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from .models.from_flax import to_flax
from .models.port_mmdet import port_mmdet_retinanet
from .utils.publish import save_published


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert an mmdet checkpoint")
    p.add_argument("checkpoint", help="mmdet .pth checkpoint")
    p.add_argument("out_file", help="output .npz path (the hash is appended)")
    p.add_argument("--depth", type=int, default=50,
                   help="backbone ResNet depth")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    ckpt = torch.load(args.checkpoint, map_location="cpu",
                      weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    meta = ckpt.get("meta", {})
    params, batch_stats = to_flax(port_mmdet_retinanet(sd, depth=args.depth))
    os.makedirs(os.path.dirname(os.path.abspath(args.out_file)),
                exist_ok=True)
    final = save_published(
        args.out_file, params, batch_stats,
        meta={"source": os.path.basename(args.checkpoint),
              "epoch": int(meta.get("epoch", 0)) if isinstance(meta, dict)
              else 0})
    print(f"converted -> {final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Single-image inference demo.

    python -m sph_retina_tpu_torch.image_demo IMG CONFIG CHECKPOINT \\
        --out vis.png [--score-thr 0.3]

``CHECKPOINT`` is a checkpoint of the trainer (its directory, whose newest
checkpoint is taken, or one ``epoch_N`` file), loaded as ``test.py`` loads
it. The image is resized to the config's ``img_size``, the family's predict
runs on the CUDA device unless ``--device cpu`` is given, and the
detections scoring at least ``--score-thr`` are drawn on the resized image
(``apis.show_result``) and saved to ``--out``.
"""

from __future__ import annotations

import argparse
import sys

from .apis import inference_detector, init_detector, show_result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Single-image inference demo")
    p.add_argument("img")
    p.add_argument("config")
    p.add_argument("checkpoint",
                   help="checkpoint directory or one epoch_N file")
    p.add_argument("--out", default="demo_out.png")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    det = init_detector(args.config, args.checkpoint, args.cfg_options,
                        device=args.device)
    img = det.pipeline.load_image(args.img)
    result = inference_detector(det, img)
    show_result(det, img, result, score_thr=args.score_thr,
                out_file=args.out)
    print(f"saved {args.out} with {sum(len(r) for r in result)} detections")
    return 0


if __name__ == "__main__":
    sys.exit(main())

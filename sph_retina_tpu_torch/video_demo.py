"""Run a detector over an ERP video and write the drawn frames as a video.

    python -m sph_retina_tpu_torch.video_demo VIDEO CONFIG [CHECKPOINT] \\
        --out OUT.avi|OUT.mp4|OUT.mov [--batch 8] [--score-thr 0.3] \\
        [--max-frames N] [--device cuda|cpu]

The twin of the JAX package's ``tools/video_demo.py``. ``VIDEO`` is read by
``data/video.py:open_video`` (Motion JPEG in AVI, MP4 or MOV, an animated
GIF, a directory of images); ``CHECKPOINT`` is what ``apis.init_detector``
loads (a published ``.npz``, a checkpoint directory or one ``epoch_N``
file; none keeps the seeded initialisation). Frames go to
``inference_detector`` ``--batch`` at a time, on the CUDA device unless
``--device cpu`` is given, and each is drawn by ``show_result`` at the
config's ``img_size`` and written by ``data/video.py:VideoWriter`` at the
input's fps, the writer made at the first drawn frame's size.

Where it differs from the JAX tool: the output is Motion JPEG (the JAX tool
writes MPEG-4 Part 2, ``mp4v``), and an ``--out`` whose suffix is not
``.avi``, ``.mp4`` or ``.mov`` exits by name before the model is built, as
does an input the video layer cannot read. A ragged last batch is not
padded to ``--batch``: the JAX tool pads it because XLA compiles a
``(k, H, W, 3)`` call with ``k < batch`` anew, while eager PyTorch compiles
nothing for a shape, and each image's result is the same either way.
"""

from __future__ import annotations

import argparse
import sys

from .apis import inference_detector, init_detector, show_result
from .data.video import VideoWriter, container_of, open_video


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Spherical video demo")
    p.add_argument("video")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out", required=True,
                   help="output video: .avi, .mp4 or .mov (Motion JPEG)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--max-frames", type=int, default=0,
                   help="stop after N frames (0 = all)")
    p.add_argument("--cfg-options", nargs="*", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    container_of(args.out)  # refuse an output suffix before any work
    reader = open_video(args.video)
    try:
        det = init_detector(args.config, args.checkpoint, args.cfg_options,
                            device=args.device)
        n_done = _run(det, reader, args)
    finally:
        reader.close()
    print(f"\n{n_done} frames -> {args.out}")
    return 0


def _run(det, reader, args) -> int:
    writer = None

    def flush(frames):
        nonlocal writer
        if not frames:
            return 0
        for frame, result in zip(frames, inference_detector(det, frames)):
            drawn = show_result(det, frame, result, score_thr=args.score_thr)
            if writer is None:
                h, w = drawn.shape[:2]
                writer = VideoWriter(args.out, reader.fps, (w, h))
            writer.write(drawn)
        return len(frames)

    n_done, batch = 0, []
    try:
        for frame in reader:
            batch.append(frame)
            if len(batch) == args.batch:
                n_done += flush(batch)
                batch = []
                print(f"\r{n_done} frames", end="", flush=True)
            if args.max_frames and n_done + len(batch) >= args.max_frames:
                break
        n_done += flush(batch)
    finally:
        if writer is not None:
            writer.close()
    return n_done


if __name__ == "__main__":
    sys.exit(main())

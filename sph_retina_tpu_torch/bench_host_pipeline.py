"""Host input-pipeline rates: what the loader sustains and where its time
goes.

    python -m sph_retina_tpu_torch.bench_host_pipeline [--img-size H W] \\
        [--n-images 256] [--workers 1 2 4 8] [--probe-link] \\
        [--out work_dirs/torch_host_pipeline.json]

- **per-stage cost** (one thread): the native decoder's fused decode +
  resize (uint8 and packed-I420 outputs), PIL's decode, the pipeline's
  resize and its host I420 pack. Where the native decoder cannot be built
  (no ``jpeglib.h``, as on the card's host) its rows read ``not available``
  with the compiler's reason, and PIL's rows are measured;
- **images a second against worker threads** for both transfer colorspaces
  through the real ``DataLoader`` (host epochs only, no device work);
- with ``--probe-link``, the host-to-card bandwidth and the
  ``data/policy.py`` ``auto`` choice it leads to (needs the card).

The JPEGs (structured content: gradients and blocks) are written once to a
cache under ``TMPDIR``. Writes one JSON report, prints it and a markdown
table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .data import native_loader
from .data.loader import DataLoader
from .data.pipeline import SphPipeline
from .geometry import generate_boxes


def ensure_jpeg_cache(h: int, w: int, n_images: int) -> str:
    """The cache directory of ``n_images`` JPEGs of (h, w), written once."""
    from PIL import Image

    cache = os.path.join(os.environ.get("TMPDIR", tempfile.gettempdir()),
                         f"sph_retina_bench_jpegs_{h}x{w}_{n_images}")
    marker = os.path.join(cache, ".complete")
    if os.path.exists(marker):
        return cache
    os.makedirs(cache, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n_images):
        r = np.random.default_rng(i)
        img = np.stack([
            (xx * (0.1 + 0.1 * (i % 5)) + r.integers(0, 60)) % 256,
            (yy * 0.3 + r.integers(0, 60)) % 256,
            ((xx + yy) * 0.2) % 256,
        ], -1).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(cache, f"{i}.jpg"),
                                  quality=85)
    with open(marker, "w") as f:
        f.write("ok")
    return cache


def time_per_image(fn, paths, warmup=2):
    for p in paths[:warmup]:
        fn(p)
    t0 = time.perf_counter()
    for p in paths:
        fn(p)
    return (time.perf_counter() - t0) / len(paths)


def native_unavailable() -> str:
    """``not available`` and the first line of the decoder's reason that
    names an error (its first line where none does)."""
    lines = [x.strip() for x in (native_loader.status()["reason"] or "")
             .splitlines() if x.strip()]
    why = next((x for x in lines if "error" in x.lower()),
               lines[0] if lines else "unknown")
    return f"not available: {why}"


def bench_stages(cache: str, img_size, n: int = 32) -> dict:
    n = min(n, len([f for f in os.listdir(cache) if f.endswith(".jpg")]))
    from PIL import Image

    paths = [os.path.join(cache, f"{i}.jpg") for i in range(n)]
    out = {}
    if native_loader.available():
        out["native_u8_decode_resize_ms"] = 1e3 * time_per_image(
            lambda p: native_loader.load_image_u8(p, img_size), paths)
        out["native_yuv_decode_resize_pack_ms"] = 1e3 * time_per_image(
            lambda p: native_loader.load_image_yuv(p, img_size), paths)
    else:
        out["native_u8_decode_resize_ms"] = \
            out["native_yuv_decode_resize_pack_ms"] = native_unavailable()

    def pil_decode(p):
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB"))

    out["pil_decode_ms"] = 1e3 * time_per_image(pil_decode, paths)
    imgs = [pil_decode(p) for p in paths[:8]]
    pipe = SphPipeline(img_size=img_size, training=False,
                       normalize_on_device=True)

    t0 = time.perf_counter()
    for im in imgs * 4:
        pipe.resize(im)
    out["pil_resize_ms"] = 1e3 * (time.perf_counter() - t0) / (len(imgs) * 4)

    resized = [pipe.resize(im) for im in imgs]
    t0 = time.perf_counter()
    for im in resized * 4:
        pipe.pack_yuv420(np.ascontiguousarray(im))
    out["host_yuv_pack_ms"] = \
        1e3 * (time.perf_counter() - t0) / (len(imgs) * 4)
    return out


def bench_loader(cache: str, img_size, n_images: int, workers_list,
                 batch: int = 8) -> dict:
    class _DiskDataset:
        def __len__(self):
            return n_images

        def __getitem__(self, idx):
            return {
                "img_id": idx,
                "img_path": os.path.join(cache, f"{idx}.jpg"),
                "boxes": generate_boxes(4, 4, seed=idx),
                "labels": np.arange(4, dtype=np.int32),
            }

    rates = {}
    for colorspace in ("rgb", "yuv420"):
        rates[colorspace] = {}
        for nw in workers_list:
            pipe = SphPipeline(img_size=img_size, max_gt=8, training=True,
                               normalize_on_device=True,
                               transfer_colorspace=colorspace)
            loader = DataLoader(_DiskDataset(), pipe, batch_size=batch,
                                num_workers=nw, prefetch=4, seed=0)
            n_done = 0
            for _ in loader.epoch(0):     # warm (page cache, pools)
                pass
            t0 = time.perf_counter()
            for _ in loader.epoch(1):
                n_done += batch
            rates[colorspace][nw] = round(
                n_done / (time.perf_counter() - t0), 1)
    return rates


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--img-size", type=int, nargs=2, default=(512, 1024))
    p.add_argument("--n-images", type=int, default=256)
    p.add_argument("--workers", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--probe-link", action="store_true",
                   help="also measure host->device bandwidth and print the "
                        "policy decision (needs the card)")
    p.add_argument("--out", default="work_dirs/torch_host_pipeline.json")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    h, w = args.img_size
    cache = ensure_jpeg_cache(h, w, args.n_images)
    report = {
        "img_size": [h, w],
        "n_images": args.n_images,
        "ncpu": os.cpu_count(),
        "stages_single_thread": bench_stages(cache, (h, w)),
        "loader_imgs_per_sec": bench_loader(cache, (h, w), args.n_images,
                                            args.workers),
    }
    if args.probe_link:
        from .data.policy import (
            _probe_link_bytes_per_sec,
            resolve_transfer_colorspace,
        )

        report["link_mb_per_sec"] = round(
            _probe_link_bytes_per_sec() / 1e6, 1)
        report["auto_colorspace"] = resolve_transfer_colorspace(
            (h, w), num_workers=max(args.workers))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))

    rates = report["loader_imgs_per_sec"]
    print("\n| workers | rgb img/s | yuv420 img/s |")
    print("|---|---|---|")
    for nw in args.workers:
        print(f"| {nw} | {rates['rgb'][nw]} | {rates['yuv420'][nw]} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())

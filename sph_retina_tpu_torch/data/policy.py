"""Transfer-colorspace policy: measured RGB-vs-YUV420 selection.

Packed I420 halves the bytes a batch moves from the host to the card but may
cost host CPU, so the better choice depends on the link and on the host.
``resolve_transfer_colorspace`` measures both: the host's decode rate of each
colorspace and the link's bandwidth, models the steady-state rate of each as

    effective(c) = min(host_rate(c) * workers, link_bytes_per_sec / bytes(c))

and picks the argmax (the JAX package's model and choice). Configs opt in
with ``data.transfer_colorspace='auto'`` (``engine.builder.build_datasets``);
explicit 'rgb' / 'yuv420' bypass the probes.
"""

from __future__ import annotations

import os
import tempfile
import time
import warnings

import numpy as np
import torch


def _probe_host_rates(img_size, n=6):
    """Single-thread images a second of the host path for both colorspaces:
    a JPEG file through the native decoder where it is available (its I420
    path decodes the raw 4:2:0 planes, which is faster than the RGB path),
    else an in-memory image through the pipeline's numpy/PIL path."""
    from . import native_loader
    from .pipeline import SphPipeline

    h, w = img_size
    img = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8)
    out = {}
    if native_loader.available():
        from PIL import Image

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "probe.jpg")
            Image.fromarray(img).save(path, quality=85)
            for name, fn in (("rgb", native_loader.load_image_u8),
                             ("yuv420", native_loader.load_image_yuv)):
                fn(path, img_size)  # warm
                t0 = time.perf_counter()
                for _ in range(n):
                    fn(path, img_size)
                out[name] = n / (time.perf_counter() - t0)
        return out

    item = {"image": img, "boxes": np.zeros((0, 4), np.float32),
            "labels": np.zeros((0,), np.int32)}
    rng = np.random.default_rng(0)
    for name in ("rgb", "yuv420"):
        pipe = SphPipeline(img_size=img_size, training=False,
                           normalize_on_device=True, transfer_colorspace=name)
        pipe(dict(item), rng)  # warm
        t0 = time.perf_counter()
        for _ in range(n):
            pipe(dict(item), rng)
        out[name] = n / (time.perf_counter() - t0)
    return out


def _probe_link_bytes_per_sec(nbytes=4 << 20, trials=2):
    """Measured host->card bandwidth: a pinned ``nbytes`` buffer copied to
    the CUDA device, timed between synchronisations. Raises without a
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to probe the link to")
    buf = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True)
    buf.to("cuda", non_blocking=True)  # warm the path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(trials):
        buf.to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    return trials * nbytes / (time.perf_counter() - t0)


def resolve_transfer_colorspace(img_size, num_workers: int = 4,
                                probe_link=None, probe_host=None) -> str:
    """Pick 'rgb' or 'yuv420' from measured host and link rates.

    Falls back to 'rgb' (the choice with no extra host work), with a
    warning, when a probe cannot run (no card, no decoder). The hooks
    replace the probes in tests. What was measured and chosen is kept in
    ``resolve_transfer_colorspace.last_probe``."""
    h, w = img_size
    workers = max(1, min(num_workers, os.cpu_count() or 1))
    record = {"host_images_per_sec": None, "link_bytes_per_sec": None,
              "workers": workers, "choice": "rgb", "error": None}
    resolve_transfer_colorspace.last_probe = record
    try:
        host = (probe_host or _probe_host_rates)(img_size)
        link = (probe_link or _probe_link_bytes_per_sec)()
    except Exception as err:  # noqa: BLE001 — any failed probe means 'rgb'
        record["error"] = f"{type(err).__name__}: {err}"
        warnings.warn(f"transfer_colorspace='auto': a probe failed "
                      f"({record['error']}); using 'rgb'", stacklevel=2)
        return "rgb"
    record["host_images_per_sec"] = dict(host)
    record["link_bytes_per_sec"] = link
    bytes_rgb = h * w * 3
    bytes_yuv = h * w * 3 // 2
    eff_rgb = min(host["rgb"] * workers, link / bytes_rgb)
    eff_yuv = min(host["yuv420"] * workers, link / bytes_yuv)
    record["effective_images_per_sec"] = {"rgb": eff_rgb, "yuv420": eff_yuv}
    record["choice"] = "yuv420" if eff_yuv > eff_rgb else "rgb"
    return record["choice"]


resolve_transfer_colorspace.last_probe = None

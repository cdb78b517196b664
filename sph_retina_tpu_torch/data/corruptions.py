"""Image corruptions for the robustness benchmark.

The port's copy of the JAX package's ``data/corruptions.py``: the 15
corruptions of the mmdet robustness benchmark (``imagecorruptions``'
severity tables), seeded, so that every evaluation is reproducible. Every
random number is drawn from the same ``np.random.Generator`` in the same
order, shape and dtype as there, so the noise is the JAX package's to the
bit. The pixels are float32 ``torch`` tensors on the host; OpenCV's calls
are ``data/imgproc.py``'s PyTorch functions, so nothing here needs OpenCV.
``jpeg_compression`` encodes with PIL.

Three corruptions deviate from the upstream library by construction, as in
the JAX package: ``frost`` overlays a procedural crystalline texture
instead of the library's bundled photographs, ``glass_blur`` resamples
through random displacement fields instead of the per-pixel swap loop, and
``elastic_transform`` warps through a shape-relative smoothed displacement
field.

Against the JAX package (``tests/test_torch_corruptions.py``): the noise
corruptions, ``brightness``, ``contrast``, ``jpeg_compression``,
``pixelate`` and ``zoom_blur`` are bitwise equal (the same arithmetic, or
OpenCV's emulated exactly); the others are within one uint8 level, since
OpenCV's float32 sums of a blur or a warp and these differ by ~1e-7 and
may move a value across a rounding boundary of ``_to_uint8``.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from .imgproc import (
    affine_transform_3pt,
    filter2d,
    gaussian_blur,
    remap,
    resize_cubic,
    resize_linear,
    resize_linear_u8,
    resize_nearest,
    rotation_matrix_2d,
    warp_affine,
)


def _to_float(img) -> torch.Tensor:
    return torch.from_numpy(np.array(img, np.uint8)).float() / 255.0


def _to_uint8(x: torch.Tensor) -> np.ndarray:
    return (x.clamp(0, 1) * 255.0 + 0.5).to(torch.uint8).numpy()


def _numpy_mean(x: torch.Tensor, axis) -> torch.Tensor:
    """numpy's float32 mean: its summation order sets the last bits, and
    those decide the rounding of every pixel the mean goes into."""
    return torch.from_numpy(x.numpy().mean(axis=axis, keepdims=True))


def _line_kernel(row: np.ndarray, angle: float) -> torch.Tensor:
    """A square kernel whose middle row is ``row``, rotated by ``angle``
    degrees about its centre and normalised to sum 1 (a motion streak)."""
    size = len(row)
    k = torch.zeros((size, size))
    k[size // 2, :] = torch.from_numpy(np.asarray(row, np.float32))
    rot = rotation_matrix_2d((size / 2 - 0.5, size / 2 - 0.5), angle, 1)
    k = warp_affine(k, rot, (size, size))
    return k / k.sum().clamp_min(1e-6)


def gaussian_noise(img, severity, rng):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    noise = rng.normal(0, c, img.shape).astype(np.float32)
    return _to_float(img) + torch.from_numpy(noise)


def shot_noise(img, severity, rng):
    c = [60, 25, 12, 5, 3][severity - 1]
    lam = (_to_float(img) * c).numpy()
    return torch.from_numpy(rng.poisson(lam).astype(np.float32)) / c


def impulse_noise(img, severity, rng):
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    x = _to_float(img)
    m = torch.from_numpy(rng.random(x.shape[:2]))
    x[m < c / 2] = 0.0
    x[m > 1 - c / 2] = 1.0
    return x


def _disk_kernel(radius):
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    k = ((x ** 2 + y ** 2) <= radius ** 2).astype(np.float32)
    return k / k.sum()


def defocus_blur(img, severity, rng):
    radius = [3, 4, 6, 8, 10][severity - 1]
    return filter2d(_to_float(img), _disk_kernel(radius))


def motion_blur(img, severity, rng):
    size = [10, 15, 15, 15, 20][severity - 1]
    angle = rng.uniform(-45, 45)
    return filter2d(_to_float(img), _line_kernel(np.ones(size), angle))


def zoom_blur(img, severity, rng):
    top = [1.11, 1.16, 1.21, 1.26, 1.31][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    acc = torch.zeros_like(x)
    factors = np.arange(1.0, top, 0.02)
    for z in factors:
        zh, zw = int(np.ceil(h * z)), int(np.ceil(w * z))
        acc += resize_linear(x, (zh, zw),
                             window=((zh - h) // 2, (zw - w) // 2, h, w))
    return (x + acc) / (len(factors) + 1)


def glass_blur(img, severity, rng):
    """A gaussian blur, then ``iters`` sweeps that each resample every
    pixel from a random neighbour within ``max_delta`` (the upstream
    per-pixel swap loop as one gather a sweep), then the blur again."""
    sigma, max_delta, iters = [(0.7, 1, 2), (0.9, 2, 1), (1.0, 2, 3),
                               (1.1, 3, 2), (1.5, 4, 2)][severity - 1]
    x = gaussian_blur(_to_float(img), sigma)
    h, w = x.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(iters):
        dy = rng.integers(-max_delta, max_delta + 1, (h, w))
        dx = rng.integers(-max_delta, max_delta + 1, (h, w))
        x = x[torch.from_numpy(np.clip(yy + dy, 0, h - 1)),
              torch.from_numpy(np.clip(xx + dx, 0, w - 1))]
    return gaussian_blur(x, sigma)


def _frost_texture(shape, rng):
    """Procedural frost: sharpened multi-octave noise for the icy grain
    plus three layers of sparse bright seeds smeared into streaks."""
    h, w = shape
    base = _plasma((h, w), rng, octaves=6) ** 2.2
    streaks = torch.zeros((h, w))
    for _ in range(3):
        g = torch.from_numpy(rng.random((h, w)).astype(np.float32))
        g = torch.where(g > 0.985, g, 0.0)  # sparse bright seeds
        size = max(7, min(h, w) // 24) | 1
        angle = rng.uniform(0, 180)
        streaks += filter2d(g, _line_kernel(np.ones(size), angle)) * size
    tex = base * 0.7 + streaks.clamp(0, 1) * 0.6
    tex -= tex.min()
    return (tex / tex.max().clamp_min(1e-6))[..., None]


def frost(img, severity, rng):
    cx, cf = [(1.0, 0.4), (0.8, 0.6), (0.7, 0.7),
              (0.65, 0.7), (0.6, 0.75)][severity - 1]
    x = _to_float(img)
    return cx * x + cf * _frost_texture(x.shape[:2], rng)


def snow(img, severity, rng):
    """A zoomed, thresholded gaussian field smeared into flakes, over a
    brightness-lifted image, added in two orientations (the upstream
    recipe)."""
    loc, scale, zoom, thresh, radius, sigma, cmix = [
        (0.1, 0.3, 3.0, 0.5, 10, 4, 0.8),
        (0.2, 0.3, 2.0, 0.5, 12, 4, 0.7),
        (0.55, 0.3, 4.0, 0.9, 12, 8, 0.7),
        (0.55, 0.3, 4.5, 0.85, 12, 8, 0.65),
        (0.55, 0.3, 2.5, 0.85, 12, 12, 0.55)][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    field = torch.from_numpy(rng.normal(loc, scale, (h, w)).astype(
        np.float32))
    zh, zw = int(np.ceil(h * zoom)), int(np.ceil(w * zoom))
    field = resize_linear(field, (zh, zw), window=(0, 0, h, w))
    field[field < thresh] = 0.0
    angle = rng.uniform(-135, -45)
    row = np.exp(-np.arange(-radius, radius + 1) ** 2 / (2.0 * sigma ** 2))
    layer = filter2d(field, _line_kernel(row, angle))[..., None]
    gray = _numpy_mean(x, 2)
    x = cmix * x + (1 - cmix) * torch.maximum(x, gray * 1.5 + 0.5)
    return x + layer + layer.flip(0, 1)


def elastic_transform(img, severity, rng):
    """A small random affine warp, then a shape-relative smoothed random
    displacement field, both sampled with ``BORDER_REFLECT``."""
    # (affine jitter, displacement amplitude, field smoothing sigma),
    # all as fractions of min(h, w)
    ca, alpha, sig = [(0.02, 0.015, 0.08), (0.03, 0.022, 0.07),
                      (0.035, 0.035, 0.06), (0.04, 0.09, 0.06),
                      (0.05, 0.14, 0.05)][severity - 1]
    x = _to_float(img)
    h, w = x.shape[:2]
    m = float(min(h, w))
    pts = np.float32([[w / 2, h / 2], [w / 2 + m / 4, h / 2],
                      [w / 2, h / 2 + m / 4]])
    jitter = rng.uniform(-ca * m, ca * m, (3, 2)).astype(np.float32)
    mat = affine_transform_3pt(pts, pts + jitter)
    x = warp_affine(x, mat, (w, h), border="reflect")
    dx = gaussian_blur(torch.from_numpy(
        rng.uniform(-1, 1, (h, w)).astype(np.float32)), sig * m)
    dy = gaussian_blur(torch.from_numpy(
        rng.uniform(-1, 1, (h, w)).astype(np.float32)), sig * m)
    norm = torch.maximum(dx.abs().max(), dy.abs().max()).clamp_min(1e-6)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    map_x = xx + dx / norm * alpha * m
    map_y = yy + dy / norm * alpha * m
    return remap(x, map_x, map_y, border="reflect")


def _plasma(shape, rng, octaves=5):
    """Multi-octave value noise (bicubically upsampled uniform grids), in
    [0, 1]: a seeded stand-in for the upstream plasma fractal."""
    h, w = shape
    field = torch.zeros((h, w))
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        g = torch.from_numpy(rng.random((gh, gw)).astype(np.float32))
        field += amp * resize_cubic(g, (h, w))
        total += amp
        amp *= 0.55
    field /= total
    field -= field.min()
    return field / field.max().clamp_min(1e-6)


def fog(img, severity, rng):
    c, blend = [(1.5, 2.0), (2.0, 2.0), (2.5, 1.7),
                (2.5, 1.5), (3.0, 1.4)][severity - 1]
    x = _to_float(img)
    f = c * _plasma(x.shape[:2], rng)[..., None] ** blend
    return (x + f) / (1.0 + c * 0.8)


def brightness(img, severity, rng):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    return _to_float(img) + c


def contrast(img, severity, rng):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    x = _to_float(img)
    mean = _numpy_mean(x, (0, 1))
    return (x - mean) * c + mean


def pixelate(img, severity, rng):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = img.shape[:2]
    small = resize_linear_u8(torch.from_numpy(np.array(img, np.uint8)),
                             (max(1, int(h * c)), max(1, int(w * c))))
    return _to_float(resize_nearest(small, (h, w)))


def jpeg_compression(img, severity, rng):
    import io

    from PIL import Image

    q = [25, 18, 15, 10, 7][severity - 1]
    buf = io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8)).save(buf, "JPEG", quality=q)
    buf.seek(0)
    return _to_float(np.asarray(Image.open(buf)))


CORRUPTIONS = {
    # the mmdet robustness benchmark's order
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "glass_blur": glass_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "snow": snow,
    "frost": frost,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "elastic_transform": elastic_transform,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
}
BENCHMARK_CORRUPTIONS = tuple(CORRUPTIONS)


def corrupt(img: np.ndarray, name: str, severity: int = 1,
            seed: int = 0) -> np.ndarray:
    """Apply a named corruption to an HWC uint8 RGB image; returns uint8.

    ``severity`` in 1..5 (0 = identity). Deterministic in (name, severity,
    seed)."""
    if severity == 0:
        return np.asarray(img, np.uint8)
    if not 1 <= severity <= 5:
        raise ValueError(f"severity {severity} not in 0..5")
    fn = CORRUPTIONS.get(name)
    if fn is None:
        raise KeyError(f"unknown corruption {name!r}; "
                       f"choose from {sorted(CORRUPTIONS)}")
    # crc32, not hash(): str hash is salted per interpreter (PYTHONHASHSEED)
    rng = np.random.default_rng(
        np.random.SeedSequence(
            [seed, severity, zlib.crc32(name.encode()) & 0x7FFFFFFF]))
    return _to_uint8(fn(np.asarray(img, np.uint8), severity, rng))


class CorruptedDataset:
    """Dataset view that decodes (if needed) and corrupts every image.

    The item carries its pixels (``image``), so ``SphPipeline`` takes its
    in-memory branch and the corruption acts on the decoded RGB image
    before the resize and the normalisation, where the reference
    pipeline's ``corrupt`` step sits."""

    def __init__(self, dataset, name: str, severity: int, seed: int = 0):
        self.dataset = dataset
        self.name, self.severity, self.seed = name, severity, seed

    def __getattr__(self, attr):
        return getattr(self.dataset, attr)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        item = dict(self.dataset[idx])
        img = item.get("image")
        if img is None:
            from PIL import Image

            with Image.open(item["img_path"]) as im:
                img = np.asarray(im.convert("RGB"))
        item["image"] = corrupt(img, self.name, self.severity,
                                seed=self.seed * 100003 + idx)
        return item

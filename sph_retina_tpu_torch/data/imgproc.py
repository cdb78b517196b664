"""The image operations the corruptions need, in plain PyTorch.

Each function stands in for one OpenCV call of the JAX package's
``data/corruptions.py`` and follows that call's sampling rule and border
rule, so that the corruptions run where OpenCV is not installed. Images are
float32 tensors laid out as OpenCV lays them out, ``(H, W)`` or ``(H, W,
C)``; ``resize_linear_u8`` and ``resize_nearest`` also take uint8. Geometry
(sample positions, weights, matrices) is worked out in float64 as OpenCV
works it out, the pixels in float32. No function here falls back to OpenCV.

Border rules, by OpenCV's names:

- ``BORDER_REFLECT_101`` (``filter2d``, ``gaussian_blur``):
  ``gfedcb|abcdefgh|gfedcba``;
- ``BORDER_REFLECT`` (``warp_affine`` / ``remap`` with ``border="reflect"``):
  ``fedcba|abcdefgh|hgfedcb``, the edge pixel repeated;
- ``BORDER_CONSTANT`` 0 (``warp_affine`` / ``remap`` with
  ``border="constant"``);
- ``BORDER_REPLICATE`` (the resizes' taps past the edge).

Both reflections are index arithmetic over any distance, not padding, so a
kernel or a warped coordinate may reach past one reflection of the image.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# OpenCV's fixed-point resize of uint8 images (INTER_RESIZE_COEF_BITS)
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _reflect_101(idx: torch.Tensor, n: int) -> torch.Tensor:
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = idx.remainder(period)
    return torch.where(idx >= n, period - idx, idx)


def _reflect(idx: torch.Tensor, n: int) -> torch.Tensor:
    period = 2 * n
    idx = idx.remainder(period)
    return torch.where(idx >= n, period - 1 - idx, idx)


def _reflect_101_pad(img: torch.Tensor, top: int, bottom: int, left: int,
                     right: int) -> torch.Tensor:
    h, w = img.shape[:2]
    rows = _reflect_101(torch.arange(-top, h + bottom), h)
    cols = _reflect_101(torch.arange(-left, w + right), w)
    return img[rows][:, cols]


def _fft_len(n: int) -> int:
    """The least ``2^a 3^b 5^c >= n``: a length the FFT handles fast."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def _correlate(img: torch.Tensor, kernel: torch.Tensor,
               anchor) -> torch.Tensor:
    """``sum_ij kernel[i, j] * img[y + i - ay, x + j - ax]`` over a
    ``BORDER_REFLECT_101`` border, by FFT in float64: the sums come out
    exact to ~1e-15, whatever the kernel's size, then rounded to float32.
    OpenCV's own float32 sums (direct, or by DFT from 130 taps) differ
    from them by ~1e-7 of the values."""
    kh, kw = kernel.shape
    ay, ax = anchor
    h, w = img.shape[:2]
    padded = _reflect_101_pad(img, ay, kh - 1 - ay, ax, kw - 1 - ax)
    x = padded.permute(2, 0, 1) if img.dim() == 3 else padded[None]
    size = (_fft_len(x.shape[1]), _fft_len(x.shape[2]))
    spectrum = torch.fft.rfft2(x.double(), s=size)
    spectrum *= torch.fft.rfft2(kernel.double(), s=size).conj()
    out = torch.fft.irfft2(spectrum, s=size)[:, :h, :w].float()
    return out.permute(1, 2, 0).contiguous() if img.dim() == 3 else out[0]


def filter2d(img: torch.Tensor, kernel) -> torch.Tensor:
    """``cv2.filter2D(img, -1, kernel)``: a correlation (the kernel is not
    flipped) with the anchor at ``(kh // 2, kw // 2)``, even sizes
    included, and ``BORDER_REFLECT_101``; the float32 kernel's sums exact
    (``_correlate``)."""
    kernel = torch.as_tensor(kernel, dtype=torch.float32)
    kh, kw = kernel.shape
    return _correlate(img, kernel, (kh // 2, kw // 2))


def gaussian_kernel(sigma: float) -> torch.Tensor:
    """``cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F)`` at the size
    ``cv2.GaussianBlur(img, (0, 0), sigma)`` picks for a float image,
    ``round(8 sigma + 1) | 1``: computed in float64, normalised, then cast
    to float32."""
    n = int(round(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    k = np.exp(x * x * (-0.5 / (sigma * sigma)))
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a float image: the
    separable float32 ``gaussian_kernel(sigma)`` along the rows and the
    columns, ``BORDER_REFLECT_101``, as one correlation with the kernel's
    outer product (exact in float64; OpenCV rounds between the passes)."""
    k = gaussian_kernel(sigma).double()
    r = k.numel() // 2
    return _correlate(img, k[:, None] * k[None, :], (r, r))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float64 (where the product of two float32 numbers
    is exact), then rounded to float32: a fused multiply-add's result, but
    for the rare sum that rounding twice moves."""
    return torch.addcmul(torch.as_tensor(c).double(),
                         torch.as_tensor(a).double(),
                         torch.as_tensor(b).double()).float()


def _lerp(p0: torch.Tensor, p1: torch.Tensor, t) -> torch.Tensor:
    """OpenCV's interpolation step ``fma(p1 - p0, t, p0)``."""
    return _fma(p1 - p0, t, p0)


def _linear_taps(src: int, dst: int, dtype=np.float64):
    """OpenCV's INTER_LINEAR taps along one axis: the two source indices,
    clamped to the image, and the float32 weight of the second. The source
    position ``(d + 0.5) * scale - 0.5``, ``scale = 1 / (dst / src)``, is
    worked out in float64 and kept in ``dtype``: float64 on OpenCV's float
    path, float32 on its fixed-point path."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(dtype)
    i = np.floor(f)
    t = (f - i).astype(np.float32)
    i = i.astype(np.int64)
    return (torch.as_tensor(np.clip(i, 0, src - 1)),
            torch.as_tensor(np.clip(i + 1, 0, src - 1)), torch.as_tensor(t))


def _along(t: torch.Tensor, axis: int, ndim: int) -> torch.Tensor:
    """``t`` shaped to broadcast along ``axis`` of an ``ndim`` image."""
    shape = [1] * ndim
    shape[axis] = -1
    return t.view(shape)


def resize_linear(img: torch.Tensor, size, window=None) -> torch.Tensor:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    float image, ``size = (h, w)``: half-pixel centres, the columns first,
    then the rows, each an OpenCV interpolation step (``_lerp``); a
    position before the first pixel or past the last takes that pixel.
    ``window = (top, left, height, width)`` computes only that part of the
    resized image (bitwise its slice)."""
    h, w = size
    top, left, wh, ww = (0, 0, h, w) if window is None else window
    x0, x1, fx = (t[left:left + ww] for t in _linear_taps(img.shape[1], w))
    y0, y1, fy = (t[top:top + wh] for t in _linear_taps(img.shape[0], h))
    x = _lerp(img[:, x0], img[:, x1], _along(fx, 1, img.dim()))
    return _lerp(x[y0], x[y1], _along(fy, 0, img.dim()))


def resize_linear_u8(img: torch.Tensor, size) -> torch.Tensor:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    uint8 image, ``size = (h, w)``: OpenCV's fixed-point path. The taps are
    ``resize_linear``'s at float32 positions, their weights ``(1 - t, t)``
    scaled by 2048 and rounded half to even. The columns are summed
    exactly in integers; each row's sum is shifted right by 4, multiplied
    by its weight and shifted right by 16 (the high half of a 16-bit
    product), and the two are added and rounded by ``(s + 2) >> 2``, which
    is OpenCV's vector rounding."""
    h, w = size
    x0, x1, fx = _linear_taps(img.shape[1], w, np.float32)
    y0, y1, fy = _linear_taps(img.shape[0], h, np.float32)

    def coefficients(t):
        return [torch.round(c.double() * _COEF_SCALE).long()
                for c in (1.0 - t, t)]

    # a column past either edge takes that pixel with weight 2048 alone;
    # the rows keep their weights (OpenCV clamps only the columns')
    fx = torch.where(x0 == x1, 0.0, fx)
    (ax0, ax1), (ay0, ay1) = coefficients(fx), coefficients(fy)
    n = img.dim()
    src = img.long()
    x = src[:, x0] * _along(ax0, 1, n) + src[:, x1] * _along(ax1, 1, n)
    s = (((x[y0] >> 4) * _along(ay0, 0, n)) >> 16) \
        + (((x[y1] >> 4) * _along(ay1, 0, n)) >> 16)
    return ((s + 2) >> 2).clamp(0, 255).to(torch.uint8)


def resize_nearest(img: torch.Tensor, size) -> torch.Tensor:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)``,
    ``size = (h, w)``: source index ``floor(d * (1 / (dst / src)))`` in
    float64, at most the last pixel."""
    h, w = size

    def index(src, dst):
        i = np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64)
        return torch.as_tensor(np.minimum(i, src - 1))

    return img[index(img.shape[0], h)][:, index(img.shape[1], w)]


def _cubic_weights(t: torch.Tensor):
    """OpenCV's ``interpolateCubic`` (A = -0.75) of float32 ``t``."""
    a = -0.75
    u, g = t + 1.0, 1.0 - t
    w0 = ((a * u - 5 * a) * u + 8 * a) * u - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1.0
    w2 = ((a + 2) * g - (a + 3)) * g * g + 1.0
    return w0, w1, w2, 1.0 - w0 - w1 - w2


def resize_cubic(img: torch.Tensor, size) -> torch.Tensor:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` of a
    float image, ``size = (h, w)``: half-pixel centres (the position in
    float64), four taps a side clamped to the image (``BORDER_REPLICATE``),
    the columns first, each sum taken left to right in float32. OpenCV's
    own sums differ from these by up to ~1e-6."""
    h, w = size

    def blend(x, axis, dst):
        src = x.shape[axis]
        f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
        i = np.floor(f)
        t = torch.as_tensor((f - i).astype(np.float32))
        i = i.astype(np.int64)
        out = None
        for k, wk in zip((-1, 0, 1, 2), _cubic_weights(t)):
            idx = torch.as_tensor(np.clip(i + k, 0, src - 1))
            term = x.index_select(axis, idx) * _along(wk, axis, x.dim())
            out = term if out is None else out + term
        return out

    return blend(blend(img, 1, w), 0, h)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the 2x3 float64
    matrix of a rotation by ``angle`` degrees (counter-clockwise on the
    screen) about ``center = (x, y)``."""
    a = math.radians(angle)
    alpha, beta = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def affine_transform_3pt(src, dst) -> np.ndarray:
    """``cv2.getAffineTransform(src, dst)``: the 2x3 float64 matrix that
    maps the three points ``src`` onto ``dst``, solved in float64."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    a = np.zeros((6, 6))
    a[0::2, 0:2], a[0::2, 2] = src, 1.0
    a[1::2, 3:5], a[1::2, 5] = src, 1.0
    return np.linalg.solve(a, dst.reshape(6)).reshape(2, 3)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


_BORDERS = ("constant", "reflect")


def _sample_bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                     border: str) -> torch.Tensor:
    """Bilinear samples of ``img`` at float32 positions ``(xs, ys)`` (pixel
    centres at integers): two interpolation steps along x, one along y
    (``_lerp``). A tap outside the image is 0 (``"constant"``) or the pixel
    ``BORDER_REFLECT`` names (``"reflect"``)."""
    if border not in _BORDERS:
        raise ValueError(f"border {border!r}: one of {_BORDERS}")
    h, w = img.shape[:2]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    x0, y0 = x0.long(), y0.long()
    if img.dim() == 3:
        fx, fy = fx[..., None], fy[..., None]

    flat = img.reshape(h * w, -1)

    def tap(yi, xi):
        if border == "reflect":
            v = flat[_reflect(yi, h) * w + _reflect(xi, w)]
        else:
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = flat[yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
            v = torch.where(inside[..., None], v, 0.0)
        return v.view(v.shape[:-1] + img.shape[2:])

    top = _lerp(tap(y0, x0), tap(y0, x0 + 1), fx)
    bottom = _lerp(tap(y0 + 1, x0), tap(y0 + 1, x0 + 1), fx)
    return _lerp(top, bottom, fy)


def warp_affine(img: torch.Tensor, m, dsize, border: str = "constant"
                ) -> torch.Tensor:
    """``cv2.warpAffine(img, m, (w, h), borderMode=...)`` of a float image,
    ``dsize = (w, h)`` as OpenCV takes it, bilinear: the output pixel
    ``(x, y)`` samples the source at the inverse of ``m`` applied to it,
    the inverse cast to float32 and the position ``fma(a, x, b * y + c)``
    in float32, as OpenCV computes it. ``border``: ``"constant"`` (0,
    OpenCV's default) or ``"reflect"``."""
    w, h = dsize
    inv = torch.as_tensor(_invert_affine(np.asarray(m, np.float64)),
                          dtype=torch.float32)
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xs = _fma(inv[0, 0], xx, yy * inv[0, 1] + inv[0, 2])
    ys = _fma(inv[1, 0], xx, yy * inv[1, 1] + inv[1, 2])
    return _sample_bilinear(img, xs, ys, border)


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
          border: str = "constant") -> torch.Tensor:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR, borderMode=...)``
    of a float image with float32 maps: the output pixel ``(x, y)`` samples
    the source bilinearly at ``(map_x[y, x], map_y[y, x])``. ``border``:
    ``"constant"`` (0) or ``"reflect"``."""
    return _sample_bilinear(img, map_x, map_y, border)

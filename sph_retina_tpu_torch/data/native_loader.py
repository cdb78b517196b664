"""ctypes bindings of the native image decoder (``csrc/sphloader.cpp``).

JPEG/PNG decode (libjpeg, libpng), bilinear resize to the configured chart,
optional horizontal flip, and one of three outputs: fp32 normalised (ImageNet
mean/std), uint8 RGB, or a packed I420 chart ``(H*3/2, W)`` uint8. The source
is the JAX package's ``native/sphloader.cpp`` byte for byte. ctypes releases
the interpreter lock for the length of each call, so the loader's threads
decode in parallel; the ``load_batch*`` functions decode a batch on a
``std::thread`` pool of their own.

The library is built at first use with the host's C++ compiler into the
package's build directory (``ops/_build.py:build_host_library``), never in
``native/``. Where it cannot be built or loaded (no compiler, no
``jpeglib.h`` / ``png.h``, no libjpeg / libpng) every function returns
``None`` and the pipeline decodes with PIL; ``status()`` says why, and how
many images the decoder has read.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import numpy as np

from ..ops._build import build_host_library

_U8P = ctypes.POINTER(ctypes.c_ubyte)
_F32P = ctypes.POINTER(ctypes.c_float)
_PATHS = ctypes.POINTER(ctypes.c_char_p)
_INTP = ctypes.POINTER(ctypes.c_int)
_c = ctypes.c_int

# The C ABI of csrc/sphloader.cpp: name -> argtypes (every restype is int).
_SIGNATURES = {
    "sph_load_image": [ctypes.c_char_p, _F32P, _c, _c, _F32P, _F32P, _c],
    "sph_load_batch": [_PATHS, _c, _F32P, _c, _c, _F32P, _F32P, _INTP, _c],
    "sph_load_image_u8": [ctypes.c_char_p, _U8P, _c, _c, _c],
    "sph_load_batch_u8": [_PATHS, _c, _U8P, _c, _c, _INTP, _c],
    "sph_load_image_yuv": [ctypes.c_char_p, _U8P, _c, _c, _c],
    "sph_load_batch_yuv": [_PATHS, _c, _U8P, _c, _c, _INTP, _c],
}

_lock = threading.Lock()
_state: dict = {"tried": False, "lib": None, "library": None, "reason": None,
                "build_seconds": 0.0}
_counts: collections.Counter = collections.Counter()


def open_library(build_dir: str | None = None) -> dict:
    """Build (if needed) and load the decoder's library.

    Returns ``{"lib", "library", "reason", "build_seconds"}``: ``lib`` is
    the ctypes handle with every function's signature declared, or ``None``
    with ``reason`` the compiler's output or the loader's error."""
    out = {"lib": None, "library": None, "reason": None, "build_seconds": 0.0}
    try:
        path, out["build_seconds"], _ = build_host_library("sphloader",
                                                           build_dir)
    except (RuntimeError, OSError) as err:
        out["reason"] = f"build failed: {err}"
        return out
    out["library"] = path
    try:
        lib = ctypes.CDLL(path)
    except OSError as err:
        out["reason"] = f"cannot load {path}: {err}"
        return out
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    out["lib"] = lib
    return out


def _load():
    """The process's library handle, built and loaded once; ``None`` when
    that failed (``status()`` says why)."""
    with _lock:
        if not _state["tried"]:
            _state.update(open_library(), tried=True)
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def status() -> dict:
    """Whether the decoder is usable, its library, why not (the compiler's
    output or the loader's error), the seconds its build took in this
    process, and the images it has decoded, in all and by function."""
    _load()
    with _lock:
        return {"available": _state["lib"] is not None,
                "library": _state["library"], "reason": _state["reason"],
                "build_seconds": _state["build_seconds"],
                "images": sum(_counts.values()), "calls": dict(_counts)}


def _count(name: str, n: int) -> None:
    with _lock:
        _counts[name] += n


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _uptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _mean_std(mean, std):
    return (np.ascontiguousarray(mean, np.float32).reshape(3),
            np.ascontiguousarray(std, np.float32).reshape(3))


def _even(img_size) -> tuple[int, int]:
    h, w = img_size
    if h % 2 or w % 2:
        raise ValueError(f"a packed I420 chart needs an even size, got {h}x{w}")
    return h, w


def load_image(path: str, img_size, mean, std, flip: bool = False):
    """Decode + resize + normalise (+ flip) one image -> (H, W, 3) float32,
    or None."""
    lib = _load()
    if lib is None:
        return None
    h, w = img_size
    out = np.empty((h, w, 3), np.float32)
    mean, std = _mean_std(mean, std)
    if lib.sph_load_image(path.encode(), _fptr(out), h, w, _fptr(mean),
                          _fptr(std), int(flip)):
        return None
    _count("load_image", 1)
    return out


def load_image_u8(path: str, img_size, flip: bool = False):
    """Decode + resize (+ flip) one image -> (H, W, 3) uint8, or None. The
    same uint8 quantisation after the bilinear resize as PIL's; the step
    normalises on the device (``pipeline.maybe_normalize_images``)."""
    lib = _load()
    if lib is None:
        return None
    h, w = img_size
    out = np.empty((h, w, 3), np.uint8)
    if lib.sph_load_image_u8(path.encode(), _uptr(out), h, w, int(flip)):
        return None
    _count("load_image_u8", 1)
    return out


def load_image_yuv(path: str, img_size, flip: bool = False):
    """Decode + resample one image -> packed I420 ``(H*3/2, W)`` uint8, or
    None.

    Rows ``[0, H)`` hold Y; rows ``[H, H*3/2)`` the chroma strip, U in
    columns ``[0, W/2)`` and V in ``[W/2, W)`` (each ``(H/2, W/2)``). Half
    the bytes of RGB uint8 from the host; the step upsamples the chroma and
    converts to RGB on the device. A JPEG is decoded to its raw 4:2:0
    planes, so the subsampled chroma carries everything the encoder kept.
    """
    lib = _load()
    if lib is None:
        return None
    h, w = _even(img_size)
    out = np.empty((h * 3 // 2, w), np.uint8)
    if lib.sph_load_image_yuv(path.encode(), _uptr(out), h, w, int(flip)):
        return None
    _count("load_image_yuv", 1)
    return out


def _batch(name, paths, out, img_size, flips, n_threads, *extra):
    """Run ``sph_load_batch*`` over ``paths`` into ``out``; returns
    ``(out, n_failed)``, the failed slots zeroed."""
    n = len(paths)
    if flips is not None and len(flips) != n:
        raise ValueError(f"{len(flips)} flips for {n} paths")
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_flips = None if flips is None else (ctypes.c_int * n)(
        *[int(f) for f in flips])
    ptr = _fptr(out) if out.dtype == np.float32 else _uptr(out)
    failed = getattr(_load(), name)(c_paths, n, ptr, *img_size, *extra,
                                    c_flips, int(n_threads))
    _count(name.replace("sph_", ""), n - failed)
    return out, int(failed)


def load_batch(paths, img_size, mean, std, flips=None, n_threads: int = 0):
    """Decode a batch in parallel -> ``((N, H, W, 3) float32, n_failed)``;
    failed slots are zeroed. ``(None, N)`` without the library."""
    if _load() is None:
        return None, len(paths)
    h, w = img_size
    mean, std = _mean_std(mean, std)
    out = np.empty((len(paths), h, w, 3), np.float32)
    return _batch("sph_load_batch", paths, out, (h, w), flips, n_threads,
                  _fptr(mean), _fptr(std))


def load_batch_u8(paths, img_size, flips=None, n_threads: int = 0):
    """``load_batch`` to ``(N, H, W, 3)`` uint8, not normalised."""
    if _load() is None:
        return None, len(paths)
    h, w = img_size
    out = np.empty((len(paths), h, w, 3), np.uint8)
    return _batch("sph_load_batch_u8", paths, out, (h, w), flips, n_threads)


def load_batch_yuv(paths, img_size, flips=None, n_threads: int = 0):
    """``load_batch`` to packed I420 ``(N, H*3/2, W)`` uint8."""
    if _load() is None:
        return None, len(paths)
    h, w = _even(img_size)
    out = np.empty((len(paths), h * 3 // 2, w), np.uint8)
    return _batch("sph_load_batch_yuv", paths, out, (h, w), flips,
                  n_threads)

"""Builds the package's CUDA sources with ``nvcc`` and loads them with ctypes.

Each kernel source under ``csrc/`` has a plain C interface (no PyTorch
headers), so one ``nvcc`` call of a few seconds turns it into a shared
library. Libraries go to ``build/torch_kernels/`` beside the package (the
repository's ``.gitignore`` lists ``build/``), named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when the package is imported: the first launch of a kernel
builds its library.

Flags: ``sm_90a`` only; no ``--use_fast_math`` (the IoU body's jitter
thresholds sit at 1e-4 degrees, and ``__sinf`` or flushed denormals would move
pairs across them); ``-fmad=false`` so that a kernel rounds every product and
sum exactly as its plain PyTorch version does, one operation at a time. Built
so, the pairwise IoU kernel equals its plain version bit for bit on an H100;
with nvcc's default contraction into FMAs it runs 10-25 % faster, but
near-degenerate pairs (identical boxes, touching cells) land on the other side
of a jitter threshold and differ by up to 2.3e-4, beyond the 1e-4 the kernel
is held to (``chip_smoke.py --fmad-probe`` measures both).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(
    os.path.dirname(_PACKAGE_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and shared memory into the log
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``PATH``, then /usr/local/cuda."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of sph_retina_tpu_torch are "
        "compiled at first use and need the CUDA toolkit")


def _source_hash(source: str, flags) -> str:
    """Hash of one .cu file, every header beside it, and the flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    names = [os.path.basename(source)] + sorted(
        f for f in os.listdir(CSRC_DIR) if f.endswith((".cuh", ".h")))
    for name in names:
        h.update(name.encode())
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library(name: str, build_dir: str | None = None,
                  flags=NVCC_FLAGS) -> tuple[str, float, str]:
    """Compile ``csrc/<name>.cu`` if no library of its hash exists yet.

    Returns (path of the shared library, seconds spent compiling, nvcc's
    output — 0.0 and "" when it was already built). Raises ``RuntimeError``
    with nvcc's output when the compilation fails.
    """
    source = os.path.join(CSRC_DIR, name + ".cu")
    if not os.path.isfile(source):
        raise FileNotFoundError(source)
    flags = tuple(flags)
    build_dir = build_dir or DEFAULT_BUILD_DIR
    out = os.path.join(build_dir, f"lib{name}-{_source_hash(source, flags)}.so")
    if os.path.isfile(out):
        return out, 0.0, ""
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [find_nvcc(), *flags, "-I", CSRC_DIR, "-o", tmp, source]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build finds a whole file
    return out, seconds, proc.stdout + proc.stderr


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_library(name)[0]
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib

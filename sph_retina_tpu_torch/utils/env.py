"""Environment collection for run logs.

One dict of the facts needed to reproduce or debug a run, logged at the top
of every training run (``train.py``): Python, the platform, torch with its
CUDA and cuDNN, the cards, numpy and PIL, and the C++ compiler the native
image decoder is built with.
"""

from __future__ import annotations

import platform
import subprocess
import sys


def _compiler() -> str:
    from ..ops._build import find_cxx

    try:
        cxx = find_cxx()
        said = subprocess.run([cxx, "--version"], capture_output=True,
                              text=True, timeout=30).stdout
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as err:
        return f"unavailable ({err})"
    return f"{cxx}: {said.splitlines()[0] if said else '?'}"


def collect_env() -> dict:
    import numpy
    import torch

    info: dict = {
        "python": sys.version.replace("\n", " "),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cudnn": torch.backends.cudnn.version()
        if torch.backends.cudnn.is_available() else None,
    }
    if torch.cuda.is_available():
        info["devices"] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
    else:
        info["devices"] = "no CUDA device"
    info["numpy"] = numpy.__version__
    try:
        import PIL

        info["PIL"] = PIL.__version__
    except ImportError:
        info["PIL"] = "unavailable"
    info["native decoder compiler"] = _compiler()
    return info


def env_string(info: dict | None = None) -> str:
    info = info or collect_env()
    return "\n".join(f"{k}: {v}" for k, v in info.items())

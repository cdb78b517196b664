"""Host CPU-feature fingerprint (stdlib only).

The native image decoder (``csrc/sphloader.cpp``) is compiled with
``-march=native``: a library built on one machine may execute instructions
another machine's CPU lacks (SIGILL). Its file name carries this fingerprint
(``ops/_build.py:build_host_library``), so a library built on another CPU is
never loaded.
"""

from __future__ import annotations

import hashlib


def cpu_feature_fingerprint() -> str:
    """12-hex-char digest of this host's CPU feature flags.

    Falls back to ``"nocpuinfo"`` where /proc/cpuinfo has no x86 ``flags``
    line (non-Linux, aarch64): distinct hosts then share one bucket.
    """
    try:
        with open("/proc/cpuinfo") as f:
            flags_line = next(l for l in f if l.startswith("flags"))
        return hashlib.sha256(flags_line.encode()).hexdigest()[:12]
    except (OSError, StopIteration):
        return "nocpuinfo"

"""Frozen seeded box generator of the benchmark's traffic.

A copy of the port's ``geometry/boxes.py:generate_boxes`` (the same numbers
from the same seed), kept here so that a change to the port cannot change
the boxes the benchmark feeds it.
"""

from __future__ import annotations

import numpy as np


def generate_boxes(n: int, box_version: int = 4, *, theta_range=(0.0, 360.0),
                   phi_range=(0.0, 180.0), fov_range=(1.0, 100.0),
                   gamma_range=(-90.0, 90.0), seed=0,
                   dtype=np.float32) -> np.ndarray:
    """Uniform random spherical boxes in degrees, (n, box_version)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(*theta_range, size=(n, 1))
    phi = rng.uniform(*phi_range, size=(n, 1))
    alpha = rng.uniform(*fov_range, size=(n, 1))
    beta = rng.uniform(*fov_range, size=(n, 1))
    cols = [theta, phi, alpha, beta]
    if box_version == 5:
        cols.append(rng.uniform(*gamma_range, size=(n, 1)))
    return np.concatenate(cols, axis=1).astype(dtype)

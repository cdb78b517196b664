"""Names of the spherical IoU backends.

The configs spell backends either by their short name or by the ``*_iou``
function names of the original Sph2Pob code base; every dispatch point
canonicalises first, so both spellings reach the same path. Of the eight
backends only ``sph2pob_efficient`` (the fused kernel) and the planar chart
IoU of the NMS are available in this package so far.
"""

from __future__ import annotations

_ALIASES = {
    "sph2pob": "sph2pob_efficient",
    "sph2pob_standard_iou": "sph2pob_standard",
    "sph2pob_efficient_iou": "sph2pob_efficient",
    "sph2pob_legacy_iou": "sph2pob_legacy",
    "unbiased_iou": "unbiased",
    "sph_iou": "sph",
    "fov_iou": "fov",
    "naive_iou": "naive",
    "kent_iou": "kent",
}

AVAILABLE_BACKENDS = ("sph2pob_efficient",)


def canonical_backend(name: str) -> str:
    """Resolve a backend name or alias spelling to its canonical form (does
    not validate: unknown names pass through for the caller's error)."""
    return _ALIASES.get(name, name)

from .rotated import box_corners, rotated_box_intersection, rotated_box_iou
from .unbiased import unbiased_iou as unbiased_iou_elementwise
from .approx import fov_iou_aligned, sph_iou_aligned
from .api import (
    BACKENDS,
    sph_overlaps,
    sph2pob_standard_iou,
    sph2pob_efficient_iou,
    sph2pob_legacy_iou,
    unbiased_iou,
    sph_iou,
    fov_iou,
    naive_iou,
    kent_iou,
)

# The Kent names are re-exported lazily (PEP 562), as in the JAX package,
# where that defers its heaviest import; here ``api`` imports ``kent``
# already, and the laziness only keeps the two packages' surfaces alike.
_KENT_EXPORTS = (
    "deg2kent",
    "kent_mle",
    "kent_iou_elementwise",
    "kent_iou_from_params",
    "kent_kld",
    "sph_kent_loss",
)


def __getattr__(name):
    if name in _KENT_EXPORTS:
        from . import kent

        return getattr(kent, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_KENT_EXPORTS))


__all__ = [
    *_KENT_EXPORTS,
    "BACKENDS",
    "box_corners",
    "rotated_box_intersection",
    "rotated_box_iou",
    "unbiased_iou_elementwise",
    "fov_iou_aligned",
    "sph_iou_aligned",
    "sph_overlaps",
    "sph2pob_standard_iou",
    "sph2pob_efficient_iou",
    "sph2pob_legacy_iou",
    "unbiased_iou",
    "sph_iou",
    "fov_iou",
    "naive_iou",
    "kent_iou",
]

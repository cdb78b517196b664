from .boxes import generate_boxes, standardize_spherical_box
from .jitter import jitter_rotated_boxes, jitter_spherical_boxes
from .sph2pob import sph2pob_efficient, sph2pob_legacy, sph2pob_standard

__all__ = [
    "generate_boxes",
    "jitter_rotated_boxes",
    "jitter_spherical_boxes",
    "sph2pob_efficient",
    "sph2pob_legacy",
    "sph2pob_standard",
    "standardize_spherical_box",
]

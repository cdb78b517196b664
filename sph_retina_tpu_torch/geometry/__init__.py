from .boxes import (generate_boxes, is_valid_boxes, longitude_tangent,
                    spherical_box_area, sph_to_unit_vec,
                    standardize_spherical_box, unit_vec_to_sph)
from .jitter import jitter_rotated_boxes, jitter_spherical_boxes
from .sph2pob import sph2pob_efficient, sph2pob_legacy, sph2pob_standard

__all__ = [
    "generate_boxes",
    "is_valid_boxes",
    "jitter_rotated_boxes",
    "jitter_spherical_boxes",
    "longitude_tangent",
    "sph2pob_efficient",
    "sph2pob_legacy",
    "sph2pob_standard",
    "sph_to_unit_vec",
    "spherical_box_area",
    "standardize_spherical_box",
    "unit_vec_to_sph",
]

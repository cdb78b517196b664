from .fused_iou import (
    fused_sph2pob_iou,
    sph2pob_disjoint_plain,
    sph2pob_iou_aligned_plain,
    sph2pob_iou_pairwise_plain,
)
from .sph2pob_iou import sph2pob_iou_aligned, sph2pob_iou_pairwise

__all__ = [
    "fused_sph2pob_iou",
    "sph2pob_disjoint_plain",
    "sph2pob_iou_aligned",
    "sph2pob_iou_aligned_plain",
    "sph2pob_iou_pairwise",
    "sph2pob_iou_pairwise_plain",
]

from .formator import (
    xyxy2xywh,
    xywh2xyxy,
    obb2hbb_xywh,
    obb2hbb_xyxy,
    sph2pix_box_transform,
    sph2planar_boxes,
)
from .anchors import SphAnchorGenerator, SphSSDAnchorGenerator
from .coders import DistancePointSphBBoxCoder, SphBBoxCoder
from .assigner import AssignResult, MaxIoUAssigner
from .sampler import RandomSampler, SampleResult, pseudo_sample
from .nms import (NMSResult, planar_batched_nms, sph_batched_nms,
                  sph_batched_soft_nms)

# The JAX package also exports bfov2rbfov, geo2sph, sph2geo,
# pix2sph_box_transform, sph2tan_box_transform, tan2sph_box_transform and
# planar2sph_boxes from here; they are not ported yet (ROADMAP).
__all__ = [
    "xyxy2xywh",
    "xywh2xyxy",
    "obb2hbb_xywh",
    "obb2hbb_xyxy",
    "sph2pix_box_transform",
    "sph2planar_boxes",
    "SphAnchorGenerator",
    "SphSSDAnchorGenerator",
    "DistancePointSphBBoxCoder",
    "SphBBoxCoder",
    "AssignResult",
    "MaxIoUAssigner",
    "RandomSampler",
    "SampleResult",
    "pseudo_sample",
    "NMSResult",
    "planar_batched_nms",
    "sph_batched_nms",
    "sph_batched_soft_nms",
]

from .formator import (
    xyxy2xywh,
    xywh2xyxy,
    obb2hbb_xywh,
    obb2hbb_xyxy,
    bfov2rbfov,
    geo2sph,
    sph2geo,
    sph2pix_box_transform,
    pix2sph_box_transform,
    sph2tan_box_transform,
    tan2sph_box_transform,
    sph2planar_boxes,
    planar2sph_boxes,
)
from .anchors import SphAnchorGenerator, SphSSDAnchorGenerator
from .coders import DistancePointSphBBoxCoder, SphBBoxCoder
from .assigner import AssignResult, MaxIoUAssigner
from .sampler import RandomSampler, SampleResult, pseudo_sample
from .nms import (NMSResult, planar_batched_nms, sph_batched_nms,
                  sph_batched_soft_nms)

__all__ = [
    "xyxy2xywh",
    "xywh2xyxy",
    "obb2hbb_xywh",
    "obb2hbb_xyxy",
    "bfov2rbfov",
    "geo2sph",
    "sph2geo",
    "sph2pix_box_transform",
    "pix2sph_box_transform",
    "sph2tan_box_transform",
    "tan2sph_box_transform",
    "sph2planar_boxes",
    "planar2sph_boxes",
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

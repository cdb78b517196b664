"""Build runtime objects from declarative config dicts:
config dicts of ``configs/`` -> model, detector config."""

from __future__ import annotations

import torch

from ..boxes.anchors import SphAnchorGenerator
from ..boxes.coders import SphBBoxCoder
from ..models.single_stage import DetectorConfig, SphRetinaNet


def parse_test_nms_cfg(cfg: dict) -> dict:
    """The post-processing keys a detector reads from ``test_cfg``
    (score_thr 0.05 / max_per_img 100 / nms 0.5 are the configs' defaults)."""
    test_cfg = cfg.get("test_cfg", {})
    nms = test_cfg.get("nms", {})
    return dict(
        score_thr=test_cfg.get("score_thr", 0.05),
        max_per_img=test_cfg.get("max_per_img", 100),
        nms_type=nms.get("type", "nms"),
        nms_iou_thr=nms.get("iou_threshold", 0.5),
    )


def build_detector_config(cfg: dict) -> DetectorConfig:
    m = cfg["model"]
    test_cfg = cfg.get("test_cfg", {})
    box_version = m.get("box_version", 4)
    anchor_cfg = dict(m.get("anchor_generator", {}))
    anchor_cfg.pop("type", None)  # registry name in configs of mmdet descent
    anchor_cfg.setdefault("strides", [8, 16, 32, 64, 128])
    anchor_cfg.setdefault("ratios", [0.5, 1.0, 2.0])
    anchor_cfg.setdefault("octave_base_scale", 4)
    anchor_cfg.setdefault("scales_per_octave", 3)
    anchor_cfg["box_version"] = box_version
    coder_cfg = m.get("bbox_coder", {})

    return DetectorConfig(
        num_classes=m["num_classes"],
        box_version=box_version,
        img_size=tuple(cfg.get("img_size", (512, 1024))),
        anchor_generator=SphAnchorGenerator(**anchor_cfg),
        bbox_coder=SphBBoxCoder(
            box_version=box_version,
            target_means=coder_cfg.get("target_means"),
            target_stds=coder_cfg.get("target_stds"),
        ),
        nms_pre=test_cfg.get("nms_pre", 1000),
        nms_backend=test_cfg.get("iou_calculator", "planar"),
        **parse_test_nms_cfg(cfg),
    )


def build_model(cfg: dict) -> SphRetinaNet:
    m = cfg["model"]
    dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
    bb = m.get("backbone", {})
    return SphRetinaNet(
        num_classes=m["num_classes"],
        box_version=m.get("box_version", 4),
        depth=bb.get("depth", 50),
        groups=bb.get("groups", 1),
        base_width=bb.get("base_width", 64),
        dtype=dtype,
    )

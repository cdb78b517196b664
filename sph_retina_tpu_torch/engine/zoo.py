"""Detector zoo: one uniform interface over the model families.

A family adapter exposes ``build(cfg_dict) -> (module, detector config)``
and ``predict_fn(model, cfg) -> f(images) -> NMSResult``. Only the RetinaNet
family is available in this package so far; the others raise
``NotImplementedError`` by name.
"""

from __future__ import annotations

import torch

from ..data.pipeline import maybe_normalize_images
from ..models.single_stage import retina_predict


class RetinaNetFamily:
    name = "SphRetinaNet"

    @staticmethod
    def build(cfg_dict):
        from .builder import build_detector_config, build_model

        return build_model(cfg_dict), build_detector_config(cfg_dict)

    @staticmethod
    def predict_fn(model, cfg):
        device = next(model.parameters()).device
        level_anchors = cfg.anchor_generator.grid_anchors(
            cfg.featmap_sizes(), device)

        @torch.no_grad()
        def f(images):
            images = maybe_normalize_images(images.to(device))
            cls, reg = model(images)
            return retina_predict(cfg, cls, reg, level_anchors)

        return f


FAMILIES = {
    "SphRetinaNet": RetinaNetFamily,
    "RetinaNet": RetinaNetFamily,
}
_NOT_PORTED = ("SphFCOS", "FCOS", "SphSSD", "SSD", "SphFasterRCNN",
               "FasterRCNN")


def get_family(cfg_dict):
    kind = cfg_dict["model"].get("type", "SphRetinaNet")
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"detector type {kind!r} is not available in this package yet; "
            f"only {sorted(set(FAMILIES))} are")
    if kind not in FAMILIES:
        raise ValueError(f"unknown detector type {kind!r}; "
                         f"choose from {sorted(set(FAMILIES))}")
    return FAMILIES[kind]

"""Detector zoo: one uniform interface over the model families.

A family adapter exposes ``build(cfg_dict) -> (module, detector config)``,
``loss_fn(model, cfg) -> f(batch, generator) -> (total, dict)`` and
``predict_fn(model, cfg) -> f(images) -> NMSResult``;
``make_generic_train_step`` serves every family. Only the RetinaNet family is
available in this package so far; the others raise ``NotImplementedError``
by name.
"""

from __future__ import annotations

import torch

from ..data.pipeline import maybe_normalize_images
from ..models.single_stage import retina_loss, retina_predict
from .train import SGDOptimizer, run_step, total_loss


class RetinaNetFamily:
    name = "SphRetinaNet"

    @staticmethod
    def build(cfg_dict):
        from .builder import build_detector_config, build_model

        return build_model(cfg_dict), build_detector_config(cfg_dict)

    @staticmethod
    def loss_fn(model, cfg):
        anchors = cfg.flat_anchors(next(model.parameters()).device)

        def f(batch, generator=None):
            del generator  # drawn from by families that sample (none yet)
            cls, reg = model(batch["images"])
            losses = retina_loss(cfg, cls, reg, anchors, batch["gt_boxes"],
                                 batch["gt_labels"], batch["gt_mask"])
            return total_loss(losses), losses

        return f

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


def make_generic_train_step(family, model, cfg, optimizer: SGDOptimizer,
                            seed: int = 0):
    """Train step serving every family: ``train_step(batch) -> metrics`` on
    a batch that lies on the model's device; the model and the optimiser are
    updated in place. The generator, seeded from ``seed``, is what a family
    that samples (RoI sampling) draws from; RetinaNet draws nothing."""
    loss = family.loss_fn(model, cfg)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)

    def train_step(batch: dict) -> dict:
        batch = dict(batch, images=maybe_normalize_images(batch["images"]))
        return run_step(optimizer, lambda: loss(batch, generator))

    return train_step

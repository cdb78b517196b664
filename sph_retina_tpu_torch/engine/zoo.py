"""Detector zoo: one uniform interface over the model families.

A family adapter exposes ``build(cfg_dict) -> (module, detector config)``,
``loss_fn(model, cfg) -> f(batch, generator) -> (total, dict)``,
``predict_module(model, cfg) -> PredictModule`` (the predict path as one
module, what ``export.py`` exports) and ``predict_fn(model, cfg) ->
f(images) -> NMSResult`` (that module on the model's device, without
gradients; on a model partitioned over "space", whole images, of which each
rank takes its columns);
``make_generic_train_step`` serves every family: RetinaNet, FCOS, SSD and
the two-stage Faster R-CNN, whose loss draws its RoI sample from the
generator.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from ..boxes.nms import NMSResult
from ..data.pipeline import maybe_normalize_images
from ..models import faster_rcnn as frcnn
from ..models.fcos import SphFCOS, fcos_config, fcos_loss, fcos_predict
from ..models.single_stage import retina_loss, retina_predict
from ..models.ssd import SphSSD, ssd_config, ssd_loss, ssd_predict
from ..parallel import get_data_rank
from ..parallel.sharding import head_part, split_head, whole_levels
from .train import SGDOptimizer, run_step, total_loss


def _common(cfg_dict):
    m = cfg_dict["model"]
    bb = m.get("backbone", {})
    return dict(
        num_classes=m["num_classes"],
        box_version=m.get("box_version", 4),
        img_size=tuple(cfg_dict.get("img_size", (512, 1024))),
        dtype=torch.bfloat16 if cfg_dict.get("bf16", True) else torch.float32,
        backbone=dict(depth=bb.get("depth", 50), groups=bb.get("groups", 1),
                      base_width=bb.get("base_width", 64),
                      remat=bb.get("remat", False)),
    )


def _reg_loss_kwargs(cfg_dict, *, decoded_flag=True):
    """``model.loss_bbox`` / ``model.reg_decoded_bbox`` -> family-config
    kwargs: the config keys RetinaNet's builder reads, so that every family
    shares one loss axis."""
    from ..losses import build_loss

    m = cfg_dict["model"]
    kw = {}
    if m.get("loss_bbox"):
        kw["loss_bbox"] = build_loss(m["loss_bbox"])
    if decoded_flag and "reg_decoded_bbox" in m:
        kw["reg_decoded_bbox"] = bool(m["reg_decoded_bbox"])
    return kw


def _device_of(model):
    return next(model.parameters()).device


class PredictModule(nn.Module):
    """A family's predict path as one module: ``forward(images)`` with
    images (B, H, W, 3), float (normalised) or uint8 (normalised here),
    returns the plain tuple ``(boxes, scores, labels, inds, valid)``, each
    with a leading (B,) axis, as the JAX package's exported ``serve`` does.
    The network is the submodule ``model``; the anchors or points of each
    level are the buffers ``prior0``, ``prior1``, ..., so that an exported
    program carries them with the weights."""

    def __init__(self, model: nn.Module, cfg, priors: Sequence[torch.Tensor],
                 head: Callable):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.head = head
        self.num_levels = len(priors)
        for i, p in enumerate(priors):
            self.register_buffer(f"prior{i}", p)

    def forward(self, images: torch.Tensor):
        priors = [getattr(self, f"prior{i}") for i in range(self.num_levels)]
        return tuple(self.head(self.model, self.cfg,
                               maybe_normalize_images(images), priors))


class _Family:
    @classmethod
    def predict_module(cls, model, cfg) -> PredictModule:
        return PredictModule(model, cfg, cls.priors(model, cfg), cls.head)

    @classmethod
    def predict_fn(cls, model, cfg):
        module = cls.predict_module(model, cfg)
        device = _device_of(model)

        axis = getattr(model, "space_axis", None)

        @torch.no_grad()
        def f(images):
            images = images.to(device)
            if axis is not None:
                images = axis.columns(images)
            return NMSResult(*module(images))

        return f


class RetinaNetFamily(_Family):
    name = "SphRetinaNet"

    @staticmethod
    def build(cfg_dict):
        from .builder import build_detector_config, build_model

        return build_model(cfg_dict), build_detector_config(cfg_dict)

    @staticmethod
    def loss_fn(model, cfg):
        """On a head split over "space" (partitioned before this call), the
        rank's own outputs and anchors (``HeadPart``)."""
        device = _device_of(model)
        anchors, axis = cfg.flat_anchors(device), split_head(model)
        split = {}
        if axis is not None:
            part = head_part(cfg.featmap_sizes(),
                             cfg.anchor_generator.num_base_anchors,
                             axis.size, axis.index, device)
            anchors = anchors[part.indices]
            split = {"group": axis.group, "anchor_index": part.indices}

        def f(batch, generator=None):
            del generator  # only Faster R-CNN's RoI sampler draws from it
            cls, reg = model(batch["images"])
            if axis is not None:
                cls, reg = part.keep(cls), part.keep(reg)
            losses = retina_loss(cfg, cls, reg, anchors, batch["gt_boxes"],
                                 batch["gt_labels"], batch["gt_mask"],
                                 **split)
            return total_loss(losses), losses

        return f

    @staticmethod
    def priors(model, cfg):
        return cfg.anchor_generator.grid_anchors(cfg.featmap_sizes(),
                                                 _device_of(model))

    @staticmethod
    def head(model, cfg, images, level_anchors):
        cls, reg = whole_levels(model, model(images), cfg.featmap_sizes())
        return retina_predict(cfg, cls, reg, level_anchors)


class FCOSFamily(_Family):
    name = "SphFCOS"

    @staticmethod
    def build(cfg_dict):
        c = _common(cfg_dict)
        model = SphFCOS(num_classes=c["num_classes"],
                        box_version=c["box_version"], dtype=c["dtype"],
                        **c["backbone"])
        # the FCOS config has no reg_decoded_bbox: its loss always sees
        # decoded boxes; like the JAX package, it reads no test_cfg
        return model, fcos_config(c["num_classes"], img_size=c["img_size"],
                                  box_version=c["box_version"],
                                  **_reg_loss_kwargs(cfg_dict,
                                                     decoded_flag=False))

    @staticmethod
    def loss_fn(model, cfg):
        """On a head split over "space", the rank's own outputs and points
        (``HeadPart``), joined as one level."""
        device = _device_of(model)
        level_points, axis = cfg.level_points(device), split_head(model)
        if axis is not None:
            part = head_part(cfg.featmap_sizes(), 1, axis.size, axis.index,
                             device)
            level_points = tuple([torch.cat(x)[part.indices]]
                                 for x in level_points)

        def f(batch, generator=None):
            del generator
            cls, reg, ctr = model(batch["images"])
            if axis is not None:
                cls, reg, ctr = (part.keep(y) for y in (cls, reg, ctr))
            losses = fcos_loss(cfg, cls, reg, ctr, batch["gt_boxes"],
                               batch["gt_labels"], batch["gt_mask"],
                               level_points)
            return total_loss(losses), losses

        return f

    @staticmethod
    def priors(model, cfg):
        return cfg.level_points(_device_of(model))[0]

    @staticmethod
    def head(model, cfg, images, points):
        cls, reg, ctr = whole_levels(model, model(images),
                                     cfg.featmap_sizes())
        return fcos_predict(cfg, cls, reg, ctr, (points,))


class SSDFamily(_Family):
    name = "SphSSD"

    @staticmethod
    def build(cfg_dict):
        c = _common(cfg_dict)
        model = SphSSD(num_classes=c["num_classes"],
                       box_version=c["box_version"], dtype=c["dtype"],
                       remat=c["backbone"]["remat"])
        # like the JAX package, the SSD config reads neither train_cfg (its
        # assigner and backend are fixed) nor test_cfg
        return model, ssd_config(c["num_classes"], img_size=c["img_size"],
                                 box_version=c["box_version"],
                                 **_reg_loss_kwargs(cfg_dict))

    @staticmethod
    def loss_fn(model, cfg):
        anchors = cfg.flat_anchors(_device_of(model))

        def f(batch, generator=None):
            del generator
            cls, reg = model(batch["images"])
            losses = ssd_loss(cfg, cls, reg, anchors, batch["gt_boxes"],
                              batch["gt_labels"], batch["gt_mask"])
            return total_loss(losses), losses

        return f

    @staticmethod
    def priors(model, cfg):
        return cfg.level_anchors(_device_of(model))

    @staticmethod
    def head(model, cfg, images, level_anchors):
        cls, reg = model(images)
        return ssd_predict(cfg, cls, reg, level_anchors)


class FasterRCNNFamily(_Family):
    name = "SphFasterRCNN"

    @staticmethod
    def build(cfg_dict):
        from .builder import parse_test_nms_cfg

        c = _common(cfg_dict)
        model = frcnn.SphFasterRCNN(num_classes=c["num_classes"],
                                    box_version=c["box_version"],
                                    dtype=c["dtype"], **c["backbone"])
        # like the JAX package, the family reads neither the assigner's
        # backend nor test_cfg.iou_calculator: its own defaults hold
        sampler = cfg_dict.get("train_cfg", {}).get("sampler", {})
        sampler_type = {"OHEMSampler": "ohem", "ohem": "ohem"}.get(
            sampler.get("type", "random"), "random")
        return model, frcnn.faster_rcnn_config(
            c["num_classes"], img_size=c["img_size"],
            box_version=c["box_version"], sampler_type=sampler_type,
            **_reg_loss_kwargs(cfg_dict), **parse_test_nms_cfg(cfg_dict))

    @staticmethod
    def loss_fn(model, cfg):
        device = _device_of(model)
        anchors = cfg.flat_anchors(device)
        level_anchors = cfg.level_anchors(device)

        def f(batch, generator=None):
            gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
            (rpn_cls, rpn_reg), feats = model(batch["images"])
            losses = frcnn.rpn_loss(cfg, rpn_cls, rpn_reg, gt[0], gt[2],
                                    anchors)
            props, _, pvalid = frcnn.rpn_proposals(cfg, rpn_cls, rpn_reg,
                                                   level_anchors)

            hardness_fn = None
            if cfg.sampler_type == "ohem":
                # a head forward (no gradient: sample_rois runs without)
                # over every candidate; its cross-entropy against the
                # assigned label ranks the candidates' hardness
                def hardness_fn(cand, labels_full):
                    rf = frcnn.roi_features(cfg, feats, cand)
                    logits, _ = model.roi(rf.flatten(0, 1))
                    logp = torch.log_softmax(logits, dim=-1)
                    ce = -logp.gather(
                        1, labels_full.reshape(-1, 1).to(torch.int64))[:, 0]
                    return ce.reshape(labels_full.shape)

            t = frcnn.sample_rois(cfg, generator, props, pvalid, *gt,
                                  hardness_fn=hardness_fn)
            rf = frcnn.roi_features(cfg, feats, t.rois)
            cls, reg = model.roi(rf.flatten(0, 1))
            losses.update(frcnn.rcnn_loss(cfg, cls, reg, t))
            return total_loss(losses), losses

        return f

    @staticmethod
    def priors(model, cfg):
        return cfg.level_anchors(_device_of(model))

    @staticmethod
    def head(model, cfg, images, level_anchors):
        (rpn_cls, rpn_reg), feats = model(images)
        props, _, pvalid = frcnn.rpn_proposals(cfg, rpn_cls, rpn_reg,
                                               level_anchors)
        rf = frcnn.roi_features(cfg, feats, props)
        cls, reg = model.roi(rf.flatten(0, 1))
        b, p = props.shape[:2]
        return frcnn.rcnn_predict(cfg, cls.reshape(b, p, -1),
                                  reg.reshape(b, p, -1), props, pvalid)


FAMILIES = {
    "SphRetinaNet": RetinaNetFamily,
    "RetinaNet": RetinaNetFamily,
    "SphFCOS": FCOSFamily,
    "FCOS": FCOSFamily,
    "SphSSD": SSDFamily,
    "SSD": SSDFamily,
    "SphFasterRCNN": FasterRCNNFamily,
    "FasterRCNN": FasterRCNNFamily,
}


def get_family(cfg_dict):
    kind = cfg_dict["model"].get("type", "SphRetinaNet")
    if kind not in FAMILIES:
        raise ValueError(f"unknown detector type {kind!r}; "
                         f"choose from {sorted(set(FAMILIES))}")
    return FAMILIES[kind]


def make_generic_train_step(family, model, cfg, optimizer: SGDOptimizer,
                            seed: int = 0):
    """Train step serving every family: ``train_step(batch) -> metrics`` on
    a batch that lies on the model's device; the model and the optimiser are
    updated in place. The generator, seeded from ``seed`` plus the rank in
    the data group (so that ranks draw independently for their different
    images, and the ranks of a "space" axis, which share theirs, draw
    alike), is what a family that samples draws from (Faster R-CNN's RoI
    sampler); the single-stage
    families draw nothing. It is ``train_step.generator``, so that a
    checkpoint can save and restore its state."""
    loss = family.loss_fn(model, cfg)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(
        seed + get_data_rank())

    def train_step(batch: dict) -> dict:
        batch = dict(batch, images=maybe_normalize_images(batch["images"]))
        return run_step(optimizer, lambda: loss(batch, generator))

    train_step.generator = generator
    return train_step

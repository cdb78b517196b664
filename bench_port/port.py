"""The system under test: the only module of the benchmark that imports the
PyTorch port (``sph_retina_tpu_torch``). It builds the port's objects from
the port's own configuration file, checks that the file states what the
benchmark's configuration says it does, and hands the benchmark's weights
to them by name.
"""

from __future__ import annotations

import os

import torch

import sph_retina_tpu_torch
from sph_retina_tpu_torch.apis import inference_detector, init_detector
from sph_retina_tpu_torch.engine.builder import build_tx
from sph_retina_tpu_torch.engine.zoo import get_family, make_generic_train_step
from sph_retina_tpu_torch.utils.config import load_config

PACKAGE_ROOT = os.path.dirname(os.path.dirname(sph_retina_tpu_torch.__file__))
# the family's name in the port's configuration files
FAMILIES = {"retinanet": "SphRetinaNet", "fcos": "SphFCOS"}
# nominal: the schedule's milestones (80 and 110 epochs) lie far beyond any
# run; only the warm-up moves the learning rate
STEPS_PER_EPOCH = 1000


def port_config(config: dict, overrides: dict | None = None) -> dict:
    """The port's configuration file of ``config``, loaded by the port, with
    ``overrides`` (a smaller test size), checked against ``config``."""
    cfg = load_config(os.path.join(PACKAGE_ROOT, config["port_config"]))
    cfg.update(overrides or {})
    m, o = cfg["model"], cfg.get("optimizer", {})
    test, lr = cfg.get("test_cfg", {}), cfg.get("lr_config", {})
    states = {
        "family": m.get("type"), "num_classes": m["num_classes"],
        "box_version": m.get("box_version", 4),
        "img_size": list(cfg.get("img_size", (512, 1024))),
        "bf16": cfg.get("bf16", True),
        "depth": m.get("backbone", {}).get("depth", 50),
        "frozen_stages": m.get("backbone", {}).get("frozen_stages", 1),
        "lr": o.get("lr"), "momentum": o.get("momentum"),
        "weight_decay": o.get("weight_decay"),
        "grad_clip": cfg.get("optimizer_config", {}).get(
            "grad_clip", {}).get("max_norm"),
        "warmup_iters": lr.get("warmup_iters"),
        "warmup_ratio": lr.get("warmup_ratio"),
        "auto_scale_lr": cfg.get("auto_scale_lr", {}).get("enable", False),
        "max_gt": cfg.get("data", {}).get("max_gt"),
    }
    want = {
        "family": FAMILIES[config["family"]],
        "num_classes": config["num_classes"],
        "box_version": config["box_version"],
        "img_size": list(config["img_size"]), "bf16": config["bf16"],
        "depth": 50, "frozen_stages": 1,
        "lr": config["optimizer"]["lr"],
        "momentum": config["optimizer"]["momentum"],
        "weight_decay": config["optimizer"]["weight_decay"],
        "grad_clip": config["optimizer"]["grad_clip"],
        "warmup_iters": config["optimizer"]["warmup_iters"],
        "warmup_ratio": config["optimizer"]["warmup_ratio"],
        "auto_scale_lr": False, "max_gt": config["max_gt"],
    }
    if config["family"] == "retinanet":
        a, t = m.get("anchor_generator", {}), cfg.get("train_cfg", {})
        states.update(
            anchors={k: a.get(k) for k in config["anchors"]},
            assigner={k: t.get("assigner", {}).get(k)
                      for k in config["assigner"]},
            assign_backend=t.get("assigner", {}).get("backend"),
            nms_backend=test.get("iou_calculator"),
            test={"nms_pre": test.get("nms_pre"),
                  "score_thr": test.get("score_thr"),
                  "iou_threshold": test.get("nms", {}).get("iou_threshold"),
                  "max_per_img": test.get("max_per_img")},
            loss_bbox=m.get("loss_bbox", {}).get("type"),
            reg_decoded_bbox=m.get("reg_decoded_bbox", False))
        want.update(anchors=config["anchors"], assigner=config["assigner"],
                    assign_backend=config["assign_backend"],
                    nms_backend="sph2pob_efficient", test=config["test"],
                    loss_bbox="SphL1Loss", reg_decoded_bbox=False)
    else:
        states["loss_bbox"] = {k: m.get("loss_bbox", {}).get(k)
                               for k in ("type", "mode")}
        want["loss_bbox"] = {"type": "Sph2PobIoULoss", "mode": "iou"}
    for key, value in (overrides or {}).items():
        if key in want:
            want[key] = states[key]
    wrong = {k: (states[k], want[k]) for k in want if states[k] != want[k]}
    if wrong:
        raise ValueError(f"{config['port_config']} does not state what the "
                         f"benchmark's configuration says (file, benchmark): "
                         f"{wrong}")
    return cfg


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: dict) -> None:
    """Copy the benchmark's tensors into the model's parameters and
    buffers of the same names; every name on both sides."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    if set(own) != set(weights):
        raise KeyError(f"weights do not fit the model: missing "
                       f"{sorted(set(own) - set(weights))[:5]}, unexpected "
                       f"{sorted(set(weights) - set(own))[:5]}")
    for name, t in own.items():
        t.copy_(weights[name])


def build_train_step(cfg: dict, weights: dict, device, seed: int):
    """(model, optimiser, train step) as the port's trainer builds them
    (``train.py:build_training``), the weights the benchmark's."""
    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    model = model.to(device)
    load_weights(model, weights)
    optimizer = build_tx(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    step = make_generic_train_step(family, model, det_cfg, optimizer,
                                   seed=seed)
    return model, optimizer, step


def build_detector(cfg: dict, weights: dict, device):
    """``init_detector`` of the configuration, the weights the
    benchmark's."""
    det = init_detector(cfg, device=device)
    load_weights(det.model, weights)
    return det


def detect(det, frames: list):
    """The timed call: ``inference_detector`` on a list of uint8 frames."""
    return inference_detector(det, frames)

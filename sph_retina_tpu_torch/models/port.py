"""Pretrained backbones: a torch checkpoint on disk -> a live detector.

The reference starts its backbone from ``torchvision://resnet50`` through
mmcv's checkpoint loader. Here a torch ``state_dict`` is read from disk
(:func:`load_torch_state_dict`), mapped onto the port's module names
(:func:`~.resnet.port_torchvision_weights` for ResNet,
:func:`~.vgg.port_torchvision_vgg16` for SSD-VGG) and copied into the
``backbone`` of a built detector (:func:`load_backbone`), strictly: a
ported key the backbone lacks, or a shape that differs, raises.
"""

from __future__ import annotations

import torch

from .resnet import ARCH_SETTINGS, as_cpu_tensor, port_torchvision_weights
from .vgg import port_torchvision_vgg16


def load_torch_state_dict(path: str) -> dict:
    """A torch checkpoint file -> a flat name -> CPU tensor mapping.

    Unwraps the common containers (a ``state_dict`` or ``model`` entry); a
    prefix such as mmdet's ``backbone.`` is left to the caller's porter.
    ``weights_only=False``: an mmcv checkpoint's ``meta`` holds objects the
    safe loader refuses.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state_dict-like mapping")
    return {k: as_cpu_tensor(v) for k, v in obj.items()}


@torch.no_grad()
def load_backbone(model: torch.nn.Module, path: str,
                  arch: str = "resnet50") -> torch.nn.Module:
    """Copy the weights of the torch checkpoint at ``path`` into
    ``model.backbone`` in place, each cast to the dtype of the tensor it
    lands in; returns ``model``. Every ported key must name a tensor of the
    backbone of the same shape (``KeyError`` / ``ValueError`` otherwise);
    tensors the checkpoint does not carry keep their values. ``arch``:
    ``resnet18/34/50/101`` or ``vgg16``."""
    state_dict = load_torch_state_dict(path)
    depths = {f"resnet{depth}": depth for depth in ARCH_SETTINGS}
    if arch in depths:
        ported = port_torchvision_weights(state_dict, depth=depths[arch])
    elif arch == "vgg16":
        ported = port_torchvision_vgg16(state_dict)
    else:
        raise ValueError(f"unknown backbone arch {arch!r}")
    own = model.backbone.state_dict()
    unknown = [key for key in ported if key not in own]
    if unknown:
        raise KeyError(f"ported key backbone.{unknown[0]} not in model "
                       f"({len(unknown)} such keys)")
    for key, value in ported.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch at backbone.{key}: model "
                f"{tuple(own[key].shape)} vs ported {tuple(value.shape)}")
    for key, value in ported.items():
        own[key].copy_(value.to(own[key].dtype))
    return model

"""Seeded weights, made on the device, handed by name to the port and to the
reference alike.

One draw of a seeded generator on the card for every kernel at once (a
convolution's N(0, 1/fan_in), as the port's own initialisation draws it),
then cut into the tensors: biases 0, norm scales and learned scalars 1,
batch-norm moments at identity, the classifier's bias at the focal prior.
The detection cell then scales its two output convolutions so that, on a
seeded frame, the class logits spread as a trained detector's do and every
image keeps a full set of detections (``calibrate``).
"""

from __future__ import annotations

import math

import torch

from .reference.nets import Detector, focal_bias

CLASSIFIERS = ("bbox_head.retina_cls.bias", "bbox_head.conv_cls.bias")


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> dict:
    """Parameters and buffers by the port's names, float32 on ``device``."""
    with torch.device("meta"):
        shapes = Detector(config["family"], config["num_classes"],
                          config["box_version"])
    params = dict(shapes.named_parameters())
    kernels = [n for n, p in params.items() if p.ndim in (2, 4)]
    total = sum(params[n].numel() for n in kernels)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, start = {}, 0
    for name, p in params.items():
        if name in kernels:
            n = p.numel()
            out[name] = (flat[start:start + n].view(p.shape)
                         / math.sqrt(math.prod(p.shape[1:])))
            start += n
        elif name.endswith("bias"):
            out[name] = torch.zeros(p.shape, device=device)
        else:
            out[name] = torch.ones(p.shape, device=device)
    for name, b in shapes.named_buffers():
        out[name] = (torch.ones if name.endswith("running_var")
                     else torch.zeros)(b.shape, device=device)
    for name in CLASSIFIERS:
        if name in out:
            out[name].fill_(focal_bias())
    return out


@torch.no_grad()
def calibrate(config: dict, weights: dict, frame_u8: torch.Tensor,
              cls_std: float = 2.0, reg_std: float = 0.3) -> None:
    """Scale the RetinaNet head's classifier and regressor kernels in place
    so that, on ``frame_u8`` (1, H, W, 3), the logits have standard
    deviation ``cls_std`` and the deltas ``reg_std`` (the reference's
    float32 forward measures them)."""
    ref = Detector(config["family"], config["num_classes"],
                   config["box_version"]).to(frame_u8.device)
    ref.load_state_dict(weights)
    cls, reg = ref(frame_u8)
    weights["bbox_head.retina_cls.weight"].mul_(
        cls_std / torch.cat([c.flatten() for c in cls]).std())
    weights["bbox_head.retina_reg.weight"].mul_(
        reg_std / torch.cat([r.flatten() for r in reg]).std())

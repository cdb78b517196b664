"""Unified spherical-IoU API: one entry point, eight backends.

- every backend is an elementwise function over box pairs, so *aligned*
  (N,) and *pairwise* (N, M) modes are the same code under broadcasting;
- degrees at this boundary, radians inside; results clamped to [0, 1];
- plain differentiable PyTorch on whatever device the boxes lie on.

Backends: ``sph2pob_efficient``, ``sph2pob_standard``, ``sph2pob_legacy``,
``unbiased`` (the exact oracle), ``sph`` / ``fov`` (planar approximations),
``naive`` (chart IoU) and ``kent`` (the Kent-distribution KLD surrogate,
``iou/kent.py``).

The configs spell backends either by their short name or by the ``*_iou``
function names of the original Sph2Pob code base; every dispatch point
canonicalises first, so both spellings reach the same path.

As in the JAX package, this module does NOT dispatch to the fused pairwise
kernel (``ops.sph2pob_iou_pairwise``): the hot callers that need it, the
anchor assignment (``models/single_stage.py``) and the NMS
(``boxes/nms.py``), call it themselves for ``sph2pob_efficient``.
"""

from __future__ import annotations

from functools import partial

import torch

from ..geometry.boxes import standardize_spherical_box
from ..geometry.jitter import jitter_rotated_boxes, jitter_spherical_boxes
from ..geometry.sph2pob import TRANSFORMS, sph2pob_legacy
from .approx import fov_iou_aligned, sph_iou_aligned
from .kent import deg2kent, kent_iou_elementwise, kent_iou_from_params
from .rotated import rotated_box_iou
from .unbiased import unbiased_iou as _unbiased_elementwise


def _sph2pob_iou_elementwise(boxes1, boxes2, *, variant: str,
                             rbb_edge: str = "arc",
                             rbb_angle: str = "equator"):
    """Jitter -> Sph2Pob transform -> jitter -> rotated IoU, degrees in."""
    boxes1, boxes2 = jitter_spherical_boxes(boxes1, boxes2)
    if variant == "sph2pob_legacy":
        boxes1, boxes2 = standardize_spherical_box(boxes1, boxes2)
        pob1, pob2 = sph2pob_legacy(torch.deg2rad(boxes1),
                                    torch.deg2rad(boxes2), rbb_edge=rbb_edge)
    else:
        pob1, pob2 = TRANSFORMS[variant](
            torch.deg2rad(boxes1), torch.deg2rad(boxes2),
            rbb_edge=rbb_edge, rbb_angle=rbb_angle)
    pob1, pob2 = jitter_rotated_boxes(pob1, pob2)
    return rotated_box_iou(pob1, pob2)


def _unbiased_deg(boxes1, boxes2):
    boxes1, boxes2 = jitter_spherical_boxes(boxes1, boxes2)
    return _unbiased_elementwise(torch.deg2rad(boxes1), torch.deg2rad(boxes2))


def _chart_deg(iou_fn, boxes1, boxes2):
    boxes1, boxes2 = jitter_spherical_boxes(boxes1, boxes2)
    boxes1, boxes2 = standardize_spherical_box(boxes1, boxes2)
    return iou_fn(boxes1, boxes2)


def _aligned_boxes_iou_xyxy(b1, b2, eps=1e-8):
    """Axis-aligned xyxy IoU, elementwise."""
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / (a1 + a2 - inter + eps)


def _naive_deg(boxes1, boxes2):
    """IoU of the boxes' rectangles in the equirectangular chart."""
    # imported here: the boxes package imports this module (through its
    # NMS), so a module-level import would be circular
    from ..boxes.formator import sph2planar_boxes

    if boxes1.shape[-1] == 4:
        return _aligned_boxes_iou_xyxy(sph2planar_boxes(boxes1),
                                       sph2planar_boxes(boxes2))
    return rotated_box_iou(sph2planar_boxes(boxes1), sph2planar_boxes(boxes2))


_BACKENDS = {
    "sph2pob_standard": partial(_sph2pob_iou_elementwise,
                                variant="sph2pob_standard"),
    "sph2pob_efficient": partial(_sph2pob_iou_elementwise,
                                 variant="sph2pob_efficient"),
    "sph2pob_legacy": partial(_sph2pob_iou_elementwise,
                              variant="sph2pob_legacy"),
    "unbiased": _unbiased_deg,
    "sph": partial(_chart_deg, sph_iou_aligned),
    "fov": partial(_chart_deg, fov_iou_aligned),
    "naive": _naive_deg,
    "kent": kent_iou_elementwise,
}

_ALIASES = {
    "sph2pob": "sph2pob_efficient",
    "sph2pob_standard_iou": "sph2pob_standard",
    "sph2pob_efficient_iou": "sph2pob_efficient",
    "sph2pob_legacy_iou": "sph2pob_legacy",
    "unbiased_iou": "unbiased",
    "sph_iou": "sph",
    "fov_iou": "fov",
    "naive_iou": "naive",
    "kent_iou": "kent",
}

BACKENDS = tuple(sorted(set(_BACKENDS) | set(_ALIASES)))
AVAILABLE_BACKENDS = tuple(_BACKENDS)  # the canonical names


def canonical_backend(name: str) -> str:
    """Resolve a backend name or alias spelling to its canonical form (does
    not validate: unknown names pass through for the caller's error)."""
    return _ALIASES.get(name, name)


def sph_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 backend: str = "sph2pob_efficient", is_aligned: bool = False,
                 **kwargs) -> torch.Tensor:
    """Spherical IoU between box sets, degrees in.

    Args:
        boxes1: (N, 4|5) spherical boxes in degrees.
        boxes2: (M, 4|5); M == N required when ``is_aligned``.
        backend: one of :data:`BACKENDS`.
        is_aligned: elementwise (N,) if True, else pairwise (N, M).

    Returns:
        IoU in [0, 1], float32.
    """
    name = canonical_backend(backend)
    if name not in _BACKENDS:
        raise ValueError(f"unknown IoU backend {backend!r}; "
                         f"choose from {BACKENDS}")
    fn = _BACKENDS[name]
    boxes1 = torch.as_tensor(boxes1).float()
    boxes2 = torch.as_tensor(boxes2).float()
    if not is_aligned and name == "kent":
        # Kent is a per-box parameterisation: convert each side once and
        # broadcast the 5 parameters, instead of running the 121-point
        # moment estimate per pair ((64, 98208) pairs would take 9 GB)
        out = kent_iou_from_params(deg2kent(boxes1)[:, None, :],
                                   deg2kent(boxes2)[None, :, :])
    elif is_aligned:
        out = fn(boxes1, boxes2, **kwargs)
    else:
        n, m = boxes1.shape[0], boxes2.shape[0]
        out = fn(boxes1[:, None, :].expand(n, m, boxes1.shape[-1]),
                 boxes2[None, :, :].expand(n, m, boxes2.shape[-1]), **kwargs)
    return out.clamp(0.0, 1.0)


# the public functions of the original code base
def sph2pob_standard_iou(b1, b2, is_aligned=False, **kw):
    return sph_overlaps(b1, b2, "sph2pob_standard", is_aligned, **kw)


def sph2pob_efficient_iou(b1, b2, is_aligned=False, **kw):
    return sph_overlaps(b1, b2, "sph2pob_efficient", is_aligned, **kw)


def sph2pob_legacy_iou(b1, b2, is_aligned=False, **kw):
    return sph_overlaps(b1, b2, "sph2pob_legacy", is_aligned, **kw)


def unbiased_iou(b1, b2, is_aligned=False):
    return sph_overlaps(b1, b2, "unbiased", is_aligned)


def sph_iou(b1, b2, is_aligned=False):
    return sph_overlaps(b1, b2, "sph", is_aligned)


def fov_iou(b1, b2, is_aligned=False):
    return sph_overlaps(b1, b2, "fov", is_aligned)


def naive_iou(b1, b2, is_aligned=False):
    return sph_overlaps(b1, b2, "naive", is_aligned)


def kent_iou(b1, b2, is_aligned=False):
    return sph_overlaps(b1, b2, "kent", is_aligned)

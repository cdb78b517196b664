"""Loss families.

All functional: ``loss(pred, target, weight=None, *, reduction, avg_factor,
loss_weight, **cfg)``. ``build_loss`` maps a config dict (mmdet-style ``type``
key) to a partially-applied function. The L1 family (``Sph2PobL1Loss``
included), the IoU family (``Sph2PobIoULoss``, ``SphIoULoss``), the focal
loss and cross-entropy are available; the Gaussian and Kent families raise
``NotImplementedError`` by name.
"""

from functools import partial

from .focal_loss import cross_entropy_loss, sigmoid_focal_loss
from .iou_loss import obb_iou_loss_terms, sph2pob_iou_loss, sph_iou_loss
from .l1_loss import obb2delta, smooth_l1_loss, sph2pob_l1_loss, sph_l1_loss
from .sph2pob_loss import sph2pob_pairs
from .utils import reduce_box_weight, weight_reduce_loss

LOSSES = {
    "SphL1Loss": sph_l1_loss,
    "L1Loss": sph_l1_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "Sph2PobL1Loss": sph2pob_l1_loss,
    "Sph2PobIoULoss": sph2pob_iou_loss,
    "SphIoULoss": sph_iou_loss,
    "FocalLoss": sigmoid_focal_loss,
    "CrossEntropyLoss": cross_entropy_loss,
}
_NOT_PORTED = ("Sph2PobGDLoss", "Sph2PobGWDLoss", "Sph2PobKLDLoss",
               "Sph2PobKFLoss", "KentLoss")


def build_loss(cfg: dict):
    """mmdet-style loss config -> callable, e.g.
    ``dict(type='SphL1Loss', loss_weight=1.0)``."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"loss type {kind!r} is not available in this package yet; "
            f"only {sorted(LOSSES)} are")
    if kind not in LOSSES:
        raise ValueError(f"unknown loss type {kind!r}; "
                         f"choose from {sorted(LOSSES)}")
    cfg.pop("use_sigmoid", None)  # mmdet's spelling of what is always on here
    return partial(LOSSES[kind], **cfg)


__all__ = [
    "LOSSES",
    "build_loss",
    "cross_entropy_loss",
    "obb2delta",
    "obb_iou_loss_terms",
    "reduce_box_weight",
    "sigmoid_focal_loss",
    "smooth_l1_loss",
    "sph2pob_iou_loss",
    "sph2pob_l1_loss",
    "sph2pob_pairs",
    "sph_iou_loss",
    "sph_l1_loss",
    "weight_reduce_loss",
]

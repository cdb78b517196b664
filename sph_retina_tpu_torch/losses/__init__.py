"""Loss families.

All functional: ``loss(pred, target, weight=None, *, reduction, avg_factor,
loss_weight, **cfg)``. ``build_loss`` maps a config dict (mmdet-style ``type``
key) to a partially-applied function: the L1 family (``Sph2PobL1Loss``
included), the IoU family (``Sph2PobIoULoss``, ``SphIoULoss``), the Gaussian
family after the Sph2Pob transform (``Sph2PobGWDLoss``, ``Sph2PobKLDLoss``,
``Sph2PobKFLoss``, and ``Sph2PobGDLoss``, whose ``loss_type`` picks GWD or
KLD), the Kent KLD loss (``KentLoss``), the focal loss and cross-entropy.
"""

from functools import partial

from ..iou.kent import sph_kent_loss
from .focal_loss import cross_entropy_loss, sigmoid_focal_loss
from .gaussian_loss import (
    gwd_terms,
    kfiou_terms,
    kld_terms,
    obb2gaussian,
    sph2pob_gwd_loss,
    sph2pob_kf_loss,
    sph2pob_kld_loss,
)
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
    "Sph2PobGDLoss": sph2pob_gwd_loss,       # loss_type picks gwd or kld
    "Sph2PobGWDLoss": sph2pob_gwd_loss,
    "Sph2PobKLDLoss": sph2pob_kld_loss,
    "Sph2PobKFLoss": sph2pob_kf_loss,
    "FocalLoss": sigmoid_focal_loss,
    "KentLoss": sph_kent_loss,
    "CrossEntropyLoss": cross_entropy_loss,
}


def build_loss(cfg: dict):
    """mmdet-style loss config -> callable, e.g.
    ``dict(type='SphL1Loss', loss_weight=1.0)``."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in LOSSES:
        raise ValueError(f"unknown loss type {kind!r}; "
                         f"choose from {sorted(LOSSES)}")
    fn = LOSSES[kind]
    if kind == "Sph2PobGDLoss":
        loss_type = cfg.pop("loss_type", "gwd")
        fn = sph2pob_kld_loss if "kld" in loss_type else sph2pob_gwd_loss
    cfg.pop("use_sigmoid", None)  # mmdet's spelling of what is always on here
    return partial(fn, **cfg)


__all__ = [
    "LOSSES",
    "build_loss",
    "cross_entropy_loss",
    "gwd_terms",
    "kfiou_terms",
    "kld_terms",
    "obb2delta",
    "obb2gaussian",
    "obb_iou_loss_terms",
    "reduce_box_weight",
    "sigmoid_focal_loss",
    "smooth_l1_loss",
    "sph2pob_gwd_loss",
    "sph2pob_iou_loss",
    "sph2pob_kf_loss",
    "sph2pob_kld_loss",
    "sph2pob_l1_loss",
    "sph2pob_pairs",
    "sph_iou_loss",
    "sph_kent_loss",
    "sph_l1_loss",
    "weight_reduce_loss",
]

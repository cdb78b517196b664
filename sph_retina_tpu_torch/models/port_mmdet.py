"""Reference (mmdet-layout) RetinaNet checkpoints -> the port's detector.

A user of the reference trains with mmdet and gets a torch checkpoint
``{"meta": ..., "state_dict": {...}}`` whose keys follow the mmdet module
tree (``backbone.layer1.0.conv1.weight``, ``neck.lateral_convs.0.conv.
weight``, ``bbox_head.retina_cls.weight``, ...). This maps such a state dict
onto the ``state_dict`` of :class:`~.single_stage.SphRetinaNet`:

- ``backbone.*``: torchvision naming, :func:`~.resnet.
  port_torchvision_weights`;
- ``neck.lateral_convs.{i}.conv`` -> ``neck.lateral_{i}``;
  ``neck.fpn_convs.{i}.conv`` -> ``neck.fpn_conv_{i}`` for the first
  ``n_laterals`` entries and ``neck.extra_conv_{i - n_laterals}`` beyond
  them (mmdet appends the ``add_extra_convs`` convs to ``fpn_convs``);
- ``bbox_head.{cls,reg}_convs.{i}.conv`` -> ``bbox_head.{cls,reg}_conv_{i}``;
  ``retina_cls`` / ``retina_reg`` map 1:1 (both heads emit (A*C)-
  interleaved channels, so no channel permutation).

Kernels stay OIHW; ``num_batches_tracked`` is not read. Any
``box_version``, and the Kent RetinaNet configs, carry through unchanged.
"""

from __future__ import annotations

from .resnet import as_cpu_tensor, port_torchvision_weights

__all__ = ["port_mmdet_retinanet", "split_prefix"]


def split_prefix(state_dict: dict, prefix: str) -> dict:
    """The entries under ``prefix``, without it (``num_batches_tracked``
    left out)."""
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix) and not k.endswith("num_batches_tracked")}


def _conv(out: dict, sd: dict, src: str, dst: str) -> None:
    out[f"{dst}.weight"] = as_cpu_tensor(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = as_cpu_tensor(sd[f"{src}.bias"])


def port_mmdet_retinanet(state_dict: dict, *, depth: int = 50,
                         n_laterals: int = 3) -> dict:
    """mmdet RetinaNet / KentRetinaNet ``state_dict`` (name -> tensor or
    array) -> the ``state_dict`` of ``SphRetinaNet`` at ``depth``."""
    out = {f"backbone.{k}": v for k, v in port_torchvision_weights(
        split_prefix(state_dict, "backbone."), depth=depth).items()}

    neck = split_prefix(state_dict, "neck.")
    i = 0
    while f"lateral_convs.{i}.conv.weight" in neck:
        _conv(out, neck, f"lateral_convs.{i}.conv", f"neck.lateral_{i}")
        i += 1
    n_laterals = i or n_laterals
    i = 0
    while f"fpn_convs.{i}.conv.weight" in neck:
        dst = (f"fpn_conv_{i}" if i < n_laterals
               else f"extra_conv_{i - n_laterals}")
        _conv(out, neck, f"fpn_convs.{i}.conv", f"neck.{dst}")
        i += 1

    head = split_prefix(state_dict, "bbox_head.")
    for tower in ("cls", "reg"):
        i = 0
        while f"{tower}_convs.{i}.conv.weight" in head:
            _conv(out, head, f"{tower}_convs.{i}.conv",
                  f"bbox_head.{tower}_conv_{i}")
            i += 1
    _conv(out, head, "retina_cls", "bbox_head.retina_cls")
    _conv(out, head, "retina_reg", "bbox_head.retina_reg")
    return out

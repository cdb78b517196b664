"""Build runtime objects from declarative config dicts:
config dicts of ``configs/`` -> model, detector config, datasets and
loaders, optimiser."""

from __future__ import annotations

import torch

from ..boxes.anchors import SphAnchorGenerator
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coders import SphBBoxCoder
from ..data import DataLoader, SphCocoDataset, SphPipeline
from ..losses import build_loss
from ..models.single_stage import DetectorConfig, SphRetinaNet
from .train import SGDOptimizer, build_optimizer, step_lr_schedule


def parse_test_nms_cfg(cfg: dict) -> dict:
    """The post-processing keys every detector family reads from
    ``test_cfg`` (score_thr 0.05 / max_per_img 100 / nms 0.5 are the
    configs' defaults; ``method`` / ``sigma`` / ``min_score`` are
    soft-NMS's)."""
    test_cfg = cfg.get("test_cfg", {})
    nms = test_cfg.get("nms", {})
    return dict(
        score_thr=test_cfg.get("score_thr", 0.05),
        max_per_img=test_cfg.get("max_per_img", 100),
        nms_type=nms.get("type", "nms"),
        nms_iou_thr=nms.get("iou_threshold", 0.5),
        soft_method=nms.get("method", "linear"),
        soft_sigma=nms.get("sigma", 0.5),
        soft_min_score=nms.get("min_score", 1e-3),
    )


def build_detector_config(cfg: dict) -> DetectorConfig:
    m = cfg["model"]
    train_cfg = cfg.get("train_cfg", {})
    test_cfg = cfg.get("test_cfg", {})
    box_version = m.get("box_version", 4)
    anchor_cfg = dict(m.get("anchor_generator", {}))
    anchor_cfg.pop("type", None)  # registry name in configs of mmdet descent
    anchor_cfg.setdefault("strides", [8, 16, 32, 64, 128])
    anchor_cfg.setdefault("ratios", [0.5, 1.0, 2.0])
    anchor_cfg.setdefault("octave_base_scale", 4)
    anchor_cfg.setdefault("scales_per_octave", 3)
    anchor_cfg["box_version"] = box_version
    coder_cfg = m.get("bbox_coder", {})
    loss_bbox_cfg = m.get("loss_bbox", {"type": "SphL1Loss"})
    assigner_cfg = dict(train_cfg.get("assigner", {}))
    assign_backend = assigner_cfg.pop("backend", "sph2pob_efficient")

    return DetectorConfig(
        num_classes=m["num_classes"],
        box_version=box_version,
        img_size=tuple(cfg.get("img_size", (512, 1024))),
        anchor_generator=SphAnchorGenerator(**anchor_cfg),
        bbox_coder=SphBBoxCoder(
            box_version=box_version,
            target_means=coder_cfg.get("target_means"),
            target_stds=coder_cfg.get("target_stds"),
        ),
        assigner=MaxIoUAssigner(
            pos_iou_thr=assigner_cfg.get("pos_iou_thr", 0.5),
            neg_iou_thr=assigner_cfg.get("neg_iou_thr", 0.4),
            min_pos_iou=assigner_cfg.get("min_pos_iou", 0.0),
        ),
        loss_bbox=build_loss(loss_bbox_cfg),
        reg_decoded_bbox=m.get("reg_decoded_bbox", False),
        loss_pos_topk=m.get("loss_pos_topk", 1024),
        assign_backend=assign_backend,
        nms_pre=test_cfg.get("nms_pre", 1000),
        nms_backend=test_cfg.get("iou_calculator", "planar"),
        **parse_test_nms_cfg(cfg),
    )


def build_model(cfg: dict) -> SphRetinaNet:
    m = cfg["model"]
    dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
    bb = m.get("backbone", {})
    return SphRetinaNet(
        num_classes=m["num_classes"],
        box_version=m.get("box_version", 4),
        depth=bb.get("depth", 50),
        groups=bb.get("groups", 1),
        base_width=bb.get("base_width", 64),
        dtype=dtype,
    )


def build_datasets(cfg: dict, split: str = "train", num_shards: int = 1,
                   shard_id: int = 0):
    """``(dataset, loader)`` of ``cfg["data"][split]``: the COCO-style
    annotation file through the pipeline. Only ``train`` flips, shuffles and
    drops the last partial batch. ``data.transfer_colorspace`` is ``"rgb"``,
    ``"yuv420"`` (which forces ``normalize_on_device``) or ``"auto"``,
    resolved by the measured policy (``data/policy.py``) for
    ``workers_per_gpu`` workers; ``data.native_decoder=False`` decodes with
    PIL. ``num_shards > 1`` raises by name (the loader says so)."""
    d = cfg["data"][split]
    box_version = cfg["model"].get("box_version", 4)
    ds = SphCocoDataset(
        ann_file=d["ann_file"],
        img_prefix=d.get("img_prefix", ""),
        box_version=box_version,
    )
    img_size = tuple(cfg.get("img_size", (512, 1024)))
    colorspace = cfg["data"].get("transfer_colorspace", "rgb")
    if colorspace == "auto":
        # measured link-vs-host trade: yuv420 where the link binds, rgb
        # where the host's decoding does
        from ..data.policy import resolve_transfer_colorspace

        colorspace = resolve_transfer_colorspace(
            img_size, num_workers=cfg["data"].get("workers_per_gpu", 4))
    pipe = SphPipeline(
        img_size=img_size,
        flip_ratio=cfg["data"].get("flip_ratio", 0.5) if split == "train" else 0.0,
        max_gt=cfg["data"].get("max_gt", 64),
        box_version=box_version,
        training=split == "train",
        normalize_on_device=cfg["data"].get("normalize_on_device", False)
        or colorspace == "yuv420",
        transfer_colorspace=colorspace,
        native_decoder=cfg["data"].get("native_decoder", True),
    )
    loader = DataLoader(
        ds, pipe,
        batch_size=cfg["data"].get("samples_per_gpu", 4),
        shuffle=split == "train",
        num_workers=cfg["data"].get("workers_per_gpu", 4),
        seed=cfg.get("seed", 0),
        aug_seed=cfg.get("aug_seed", None),
        drop_last=split == "train",
        num_shards=num_shards,
        shard_id=shard_id,
    )
    return ds, loader


def scaled_base_lr(cfg: dict, num_processes: int = 1) -> float:
    """Linear LR scaling rule (``auto_scale_lr``): when enabled, scale the
    configured lr by global_batch / base_batch_size, the global batch being
    ``num_processes * samples_per_gpu``."""
    opt = cfg.get("optimizer", {})
    lr = opt.get("lr", 0.005)
    asl = cfg.get("auto_scale_lr", {})
    if not asl.get("enable", False):
        return lr
    base = asl.get("base_batch_size")
    if not base:
        return lr
    batch = num_processes * cfg.get("data", {}).get("samples_per_gpu", 4)
    return lr * batch / base


def build_tx(cfg: dict, model: torch.nn.Module, steps_per_epoch: int,
             num_processes: int = 1) -> SGDOptimizer:
    """The optimiser the config describes, over ``model``'s parameters
    (the name is the JAX package's, where it makes an optax transformation)."""
    opt = cfg.get("optimizer", {})
    lr_cfg = cfg.get("lr_config", {})
    schedule = step_lr_schedule(
        scaled_base_lr(cfg, num_processes),
        steps_per_epoch,
        milestones=tuple(lr_cfg.get("step", (80, 110))),
        warmup_iters=lr_cfg.get("warmup_iters", 500),
        warmup_ratio=lr_cfg.get("warmup_ratio", 0.001),
    )
    clip = cfg.get("optimizer_config", {}).get("grad_clip")
    if "frozen_prefixes" in cfg:
        frozen = tuple(cfg["frozen_prefixes"])
    else:
        # From model.backbone.frozen_stages (mmdet ResNet._freeze_stages:
        # >= 0 freezes the stem, 1..N freeze layer1..layerN; -1 freezes
        # nothing). The shipped configs use frozen_stages=1.
        fs = cfg.get("model", {}).get("backbone", {}).get("frozen_stages", 1)
        frozen = ()
        if fs >= 0:
            frozen += ("backbone/conv1", "backbone/bn1")
        frozen += tuple(f"backbone/layer{i}" for i in range(1, fs + 1))
    # EMAHook: configs enable weight averaging via
    # custom_hooks=[dict(type='EMAHook', momentum=...)]; a bare
    # ``ema_momentum`` key is also accepted.
    ema = cfg.get("ema_momentum")
    for hook in cfg.get("custom_hooks", []) or []:
        if isinstance(hook, dict) and "EMA" in str(hook.get("type", "")):
            ema = hook.get("momentum", 0.0002)
    return build_optimizer(
        model,
        schedule,
        momentum=opt.get("momentum", 0.9),
        weight_decay=opt.get("weight_decay", 5e-4),
        grad_clip=clip.get("max_norm") if isinstance(clip, dict) else clip,
        frozen_prefixes=frozen,
        ema_momentum=ema,
    )

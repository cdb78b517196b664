"""High-level programmatic inference API.

- ``init_detector``      builds a detector from a config and a checkpoint
- ``inference_detector`` runs it on one image or a list of images
- ``show_result``        draws a result on its image

Results come per image as a list of ``num_classes`` numpy arrays of shape
(n_i, box_version + 1) (boxes in spherical degrees + score) — the format the
analysis tools written against mmdet consume, and the one the JAX package
returns.

The entry points run on the CUDA device unless the caller asks for
``device="cpu"``; without a card they raise instead of carrying on on the
CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .data.pipeline import SphPipeline
from .engine.runner import load_checkpoint
from .engine.zoo import get_family
from .models.from_flax import load_flax_variables
from .utils.config import apply_overrides, load_config
from .utils.device import resolve_device
from .utils.publish import load_published
from .visualize import draw_boxes

__all__ = ["Detector", "init_detector", "inference_detector", "show_result"]


@dataclass
class Detector:
    """Bundle returned by :func:`init_detector`."""

    model: Any
    cfg: dict
    det_cfg: Any
    predict: Callable
    pipeline: Any
    num_classes: int
    box_version: int
    device: torch.device


def init_detector(config, checkpoint: str | None = None,
                  cfg_options: Sequence[str] | None = None,
                  seed: int = 0, device=None) -> Detector:
    """Build a detector from a config (path or dict) + optional checkpoint.

    ``checkpoint``: a published ``.npz`` (as either package's
    ``save_published`` writes it), or a checkpoint of the trainer — its
    directory (the newest checkpoint there) or one ``epoch_N`` file — whose
    model weights are loaded (not the EMA shadow); ``None`` keeps the random
    initialisation drawn from ``seed``. ``device``: ``None`` means the CUDA
    device.
    """
    device = resolve_device(device)
    cfg = dict(config) if isinstance(config, dict) else load_config(config)
    if cfg_options:
        cfg = apply_overrides(cfg, list(cfg_options))

    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    h, w = cfg.get("img_size", (512, 1024))
    if checkpoint is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    elif str(checkpoint).endswith(".npz"):
        params, batch_stats, _ = load_published(checkpoint)
        load_flax_variables(model, params, batch_stats)
    elif os.path.isdir(checkpoint) or os.path.isfile(checkpoint):
        load_checkpoint(checkpoint, model)
    else:
        raise NotImplementedError(
            f"checkpoint {checkpoint!r}: neither a published .npz nor a "
            "checkpoint of the trainer (a directory of epoch_N files, or one "
            "of them)")
    model = model.to(device).eval()

    bv = cfg["model"].get("box_version", 4)
    pipeline = SphPipeline(img_size=(h, w))
    return Detector(model=model, cfg=cfg, det_cfg=det_cfg,
                    predict=family.predict_fn(model, det_cfg),
                    pipeline=pipeline,
                    num_classes=cfg["model"]["num_classes"], box_version=bv,
                    device=device)


def _prepare(det: Detector, img) -> np.ndarray:
    """-> resized uint8 (H, W, 3); normalisation happens on the device."""
    if isinstance(img, str):
        img = det.pipeline.load_image(img)
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.dtype != np.uint8:
        # float arrays are 0-255 scale (images stay 0-255 until Normalize)
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return det.pipeline.resize(img)


def inference_detector(det: Detector, imgs):
    """Run inference on one image or a list of images.

    ``imgs``: file path, HxWx3 uint8/float array, or a list of either.
    Returns (for each image) a list of ``num_classes`` float32 arrays of
    shape (n_i, box_version + 1) — spherical degrees + score; the list is
    unwrapped for a single input.
    """
    is_batch = isinstance(imgs, (list, tuple))
    img_list = list(imgs) if is_batch else [imgs]

    batch = torch.from_numpy(
        np.stack([np.ascontiguousarray(_prepare(det, im)) for im in img_list]))
    res = det.predict(batch)

    boxes = res.boxes.float().cpu().numpy()
    scores = res.scores.float().cpu().numpy()
    labels = res.labels.cpu().numpy()
    valid = res.valid.cpu().numpy()

    results = []
    for i in range(len(img_list)):
        per_class = []
        for c in range(det.num_classes):
            sel = valid[i] & (labels[i] == c)
            per_class.append(
                np.concatenate([boxes[i][sel], scores[i][sel, None]],
                               axis=1))
        results.append(per_class)
    return results if is_batch else results[0]


def show_result(det: Detector, img, result, score_thr: float = 0.3,
                out_file: str | None = None) -> np.ndarray:
    """Draw a result (the per-class list of :func:`inference_detector`) on
    the resized image; returns the rendered uint8 array and writes it to
    ``out_file`` where given."""
    raw = _prepare(det, img)
    boxes, labels, scores = [], [], []
    for c, dets in enumerate(result):
        for row in dets:
            boxes.append(row[:-1])
            scores.append(row[-1])
            labels.append(c)
    if boxes:
        boxes = np.stack(boxes)
        labels = np.asarray(labels)
        scores = np.asarray(scores)
    else:
        boxes = np.zeros((0, det.box_version), np.float32)
        labels = np.zeros((0,), np.int64)
        scores = np.zeros((0,), np.float32)
    out = draw_boxes(raw, boxes, labels, scores, score_thr=score_thr)
    if out_file:
        from PIL import Image

        Image.fromarray(out).save(out_file)
    return out

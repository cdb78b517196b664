"""Dataset evaluation: run the detector over a loader, compute mAP."""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import PinnedStaging, prefetch_to_device, to_device
from ..parallel import all_gather_eval_arrays
from .eval import eval_spherical_map
from .zoo import RetinaNetFamily

_KEYS = ("boxes", "scores", "labels", "valid", "gt_boxes", "gt_labels",
         "gt_mask", "ig_boxes", "ig_labels", "ig_mask", "img_id")


def make_predict_step(model, cfg):
    """The RetinaNet predict: ``predict(images) -> NMSResult``."""
    return RetinaNetFamily.predict_fn(model, cfg)


def evaluate_dataset(
    model,
    cfg,
    loader,
    *,
    backend: str = "sph2pob_efficient",
    iou_thrs=None,
    predict=None,
    device=None,
    distributed: bool = False,
    return_raw: bool = False,
) -> dict:
    """Run inference over a (non-shuffled) loader and compute COCO-style AP.

    ``predict(images) -> NMSResult`` defaults to the RetinaNet path; pass a
    zoo family's ``predict_fn`` for other detectors. It runs under
    ``torch.no_grad()`` with the model in ``eval()`` mode; the model is put
    back in the mode it was found in. ``device`` is where the images are
    sent (``prefetch_to_device``: on a copy stream of its own on the card)
    and the matcher's IoU matrices computed (``None``: the model's device).

    ``distributed=True``: the loader is this process's shard
    (``DataLoader(num_shards=world, shard_id=rank)``); the padded result
    arrays of every process are gathered to every process and de-duplicated
    by image id, keeping the first (the shards' wrap-padding repeats a few
    images), before scoring, so that every process returns the metrics of
    the whole dataset.
    """
    if predict is None:
        predict = make_predict_step(model, cfg)
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)
    staging = PinnedStaging() if device.type == "cuda" else None

    def transfer(batch):
        return batch, to_device({"images": batch["images"]}, device,
                                staging)["images"]

    acc = {k: [] for k in _KEYS}
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for batch, images in prefetch_to_device(
                    loader.epoch(0), transfer, device=device):
                res = predict(images)
                b, _, d = batch["gt_boxes"].shape
                acc["boxes"].append(res.boxes.float().cpu().numpy())
                acc["scores"].append(res.scores.float().cpu().numpy())
                acc["labels"].append(res.labels.cpu().numpy())
                acc["valid"].append(res.valid.cpu().numpy())
                for k in ("gt_boxes", "gt_labels", "gt_mask"):
                    acc[k].append(np.asarray(batch[k]))
                # crowd/ignore regions (COCO iscrowd): absent from synthetic
                # batches
                acc["ig_boxes"].append(np.asarray(
                    batch.get("ig_boxes", np.ones((b, 1, d), np.float32))))
                acc["ig_labels"].append(np.asarray(
                    batch.get("ig_labels", np.zeros((b, 1), np.int32))))
                acc["ig_mask"].append(np.asarray(
                    batch.get("ig_mask", np.zeros((b, 1), bool))))
                acc["img_id"].append(np.asarray(
                    batch.get("img_id", np.full(b, -1, np.int64))))
    finally:
        model.train(was_training)
    arrays = {k: np.concatenate(v, axis=0) for k, v in acc.items()}

    if distributed:
        arrays = all_gather_eval_arrays(arrays)
        if np.all(arrays["img_id"] >= 0):
            _, first = np.unique(arrays["img_id"], return_index=True)
            keep = np.sort(first)
            arrays = {k: v[keep] for k, v in arrays.items()}

    det_results, annotations = [], []
    for i in range(arrays["boxes"].shape[0]):
        v = arrays["valid"][i]
        det_results.append((arrays["boxes"][i][v], arrays["scores"][i][v],
                            arrays["labels"][i][v]))
        m = arrays["gt_mask"][i]
        im = arrays["ig_mask"][i]
        annotations.append({
            "boxes": arrays["gt_boxes"][i][m],
            "labels": arrays["gt_labels"][i][m],
            "ignore_boxes": arrays["ig_boxes"][i][im],
            "ignore_labels": arrays["ig_labels"][i][im],
        })
    kwargs = {} if iou_thrs is None else {"iou_thrs": iou_thrs}
    metrics = eval_spherical_map(
        det_results, annotations, cfg.num_classes, backend=backend,
        device=device, **kwargs)
    metrics["n_images"] = int(arrays["boxes"].shape[0])
    if return_raw:
        return metrics, arrays
    return metrics

"""Host-side data pipeline: decode -> SphResize -> SphRandomFlip -> Normalize.

- ``SphResize (1024, 512) keep_ratio``: ERP images are 2:1, so this is a
  plain resize of the *image only* — spherical degree boxes are
  resolution-independent.
- ``SphRandomFlip 0.5``: horizontal flip of the image plus theta -> 360 -
  theta on boxes (and gamma -> -gamma for RBFoV).
- ``Normalize``: ImageNet mean/std, RGB — on the host, or on the device when
  ``normalize_on_device`` ships raw uint8.

Output images are (H, W, 3), boxes padded to ``max_gt`` with a mask. numpy on
the host; PIL is imported only when an image file has to be decoded or an
image resized, so a machine without PIL can still serve and train on arrays
that already have the configured size. Batching lives in ``loader.py``. The
packed-I420 transfer (``transfer_colorspace="yuv420"``) and the native decoder
of the JAX package are not part of this package yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclass
class SphPipeline:
    img_size: tuple = (512, 1024)  # (H, W)
    flip_ratio: float = 0.5
    max_gt: int = 64
    box_version: int = 4
    training: bool = True
    mean: np.ndarray = None
    std: np.ndarray = None
    # Crowd/ignore regions (COCO iscrowd) carried for evaluation only;
    # padded separately from training GT.
    max_ignore: int = 16
    # Ship raw uint8 to the device and let the step normalise
    # (maybe_normalize_images): 4x fewer bytes per batch from the host,
    # identical numerics (source pixels are uint8 either way).
    normalize_on_device: bool = False
    transfer_colorspace: str = "rgb"

    def __post_init__(self):
        self.mean = IMAGENET_MEAN if self.mean is None else self.mean
        self.std = IMAGENET_STD if self.std is None else self.std
        if self.transfer_colorspace == "yuv420":
            raise NotImplementedError(
                "transfer_colorspace='yuv420' (packed I420 batches) is not "
                "available in this package yet; use 'rgb'")
        if self.transfer_colorspace != "rgb":
            raise ValueError(
                f"transfer_colorspace must be 'rgb' or 'yuv420', got "
                f"{self.transfer_colorspace!r}")

    def load_image(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def resize(self, img: np.ndarray) -> np.ndarray:
        h, w = self.img_size
        if img.shape[:2] == (h, w):
            return img
        from PIL import Image

        return np.asarray(
            Image.fromarray(img).resize((w, h), Image.BILINEAR)
        )

    def normalize(self, img: np.ndarray) -> np.ndarray:
        return (img.astype(np.float32) - self.mean) / self.std

    def pad_gt(self, boxes, labels, max_n=None):
        g = self.max_gt if max_n is None else max_n
        out_boxes = np.zeros((g, self.box_version), np.float32)
        out_boxes[:, :] = 1.0  # harmless non-degenerate padding
        out_labels = np.zeros((g,), np.int32)
        mask = np.zeros((g,), bool)
        n = min(len(boxes), g)
        if n:
            out_boxes[:n] = boxes[:n]
            out_labels[:n] = labels[:n]
            mask[:n] = True
        return out_boxes, out_labels, mask

    def __call__(self, item: dict, rng: np.random.Generator) -> dict:
        """One dataset item (``image`` or ``img_path``, ``boxes``, ``labels``,
        optionally ``ignore_boxes`` / ``ignore_labels`` / ``img_id``) -> one
        padded sample; ``rng`` decides the flip."""
        do_flip = self.training and rng.random() < self.flip_ratio
        boxes = np.asarray(item["boxes"], np.float32).reshape(
            -1, self.box_version)
        raw = item.get("image")
        if raw is None:
            raw = self.load_image(item["img_path"])
        raw = self.resize(raw)
        if do_flip:
            raw = raw[:, ::-1]
        if self.normalize_on_device:
            img = np.ascontiguousarray(raw)  # uint8; the step normalises
        else:
            img = self.normalize(raw)
        ig_boxes = np.asarray(
            item.get("ignore_boxes", np.zeros((0, self.box_version))),
            np.float32).reshape(-1, self.box_version)

        def flip_boxes(b):
            b = b.copy()
            b[:, 0] = 360.0 - b[:, 0]
            if b.shape[1] == 5:
                b[:, 4] = -b[:, 4]
            return b

        if do_flip and boxes.shape[0]:
            boxes = flip_boxes(boxes)
        if do_flip and ig_boxes.shape[0]:
            ig_boxes = flip_boxes(ig_boxes)
        gt_boxes, gt_labels, gt_mask = self.pad_gt(boxes, item["labels"])
        ig_labels = np.asarray(item.get("ignore_labels", np.zeros((0,))),
                               np.int32)
        ig_boxes, ig_labels, ig_mask = self.pad_gt(
            ig_boxes, ig_labels, max_n=self.max_ignore)
        return {
            "images": img,
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
            "gt_mask": gt_mask,
            "ig_boxes": ig_boxes,
            "ig_labels": ig_labels,
            "ig_mask": ig_mask,
            "img_id": np.int32(item.get("img_id", 0)),
        }


def maybe_normalize_images(images: torch.Tensor) -> torch.Tensor:
    """Normalise uint8 RGB image batches on the device (ImageNet mean/std).

    Shipping raw uint8 moves 4x fewer bytes from the host per batch than
    fp32. Float inputs pass through unchanged (already normalised on the
    host). Numerically the same either way: the source pixels are uint8.
    """
    if images.dtype != torch.uint8:
        return images
    if images.shape[-1] != 3:
        raise NotImplementedError(
            "only uint8 RGB (..., H, W, 3) batches are normalised on the "
            f"device in this package yet, got shape {tuple(images.shape)}")
    mean = torch.from_numpy(IMAGENET_MEAN).to(images.device)
    std = torch.from_numpy(IMAGENET_STD).to(images.device)
    return (images.to(torch.float32) - mean) / std

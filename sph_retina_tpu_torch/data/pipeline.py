"""Host-side image preparation for inference: decode -> resize -> normalize.

ERP images are 2:1, so the resize is a plain resize of the image; spherical
degree boxes are resolution-independent. Normalisation is ImageNet mean/std
on RGB. numpy on the host; PIL is imported only when an image file has to be
decoded or an image resized, so a machine without PIL can still serve arrays
that already have the configured size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclass
class SphPipeline:
    """The evaluation half of the data pipeline."""

    img_size: tuple = (512, 1024)  # (H, W)
    mean: np.ndarray = None
    std: np.ndarray = None

    def __post_init__(self):
        self.mean = IMAGENET_MEAN if self.mean is None else self.mean
        self.std = IMAGENET_STD if self.std is None else self.std

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

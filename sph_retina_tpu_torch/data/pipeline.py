"""Host-side data pipeline: decode -> SphResize -> SphRandomFlip -> Normalize.

- ``SphResize (1024, 512) keep_ratio``: ERP images are 2:1, so this is a
  plain resize of the *image only* — spherical degree boxes are
  resolution-independent.
- ``SphRandomFlip 0.5``: horizontal flip of the image plus theta -> 360 -
  theta on boxes (and gamma -> -gamma for RBFoV).
- ``Normalize``: ImageNet mean/std, RGB — on the host, or on the device when
  ``normalize_on_device`` ships raw uint8.

Output images are (H, W, 3), or a packed I420 chart (H*3/2, W) with
``transfer_colorspace="yuv420"``; boxes padded to ``max_gt`` with a mask.
An item that names a file (``img_path``) is decoded, resized and flipped by
the native C++ decoder (``native_loader``) where it is available, else by
PIL; an item that carries its pixels (``image``) takes the numpy/PIL path.
PIL is imported only when a file has to be decoded or an image resized.
Batching lives in ``loader.py``; ``maybe_normalize_images`` turns a uint8
RGB or I420 batch into the network's normalised input on the device.
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
    # "rgb" ships (H, W, 3) uint8. "yuv420" ships a packed I420 chart
    # (H*3/2, W) uint8 — half the bytes again; the step upsamples chroma and
    # converts YCbCr->RGB (JFIF full range, the JPEG matrix) on the device
    # before normalising. Near-lossless for JPEG sources (their chroma is
    # 4:2:0 already); requires normalize_on_device.
    transfer_colorspace: str = "rgb"
    # Decode files with the native C++ decoder where it is available; False
    # decodes with PIL always.
    native_decoder: bool = True

    def __post_init__(self):
        self.mean = IMAGENET_MEAN if self.mean is None else self.mean
        self.std = IMAGENET_STD if self.std is None else self.std
        if self.transfer_colorspace not in ("rgb", "yuv420"):
            raise ValueError(
                f"transfer_colorspace must be 'rgb' or 'yuv420', got "
                f"{self.transfer_colorspace!r}")
        if self.transfer_colorspace == "yuv420" and not self.normalize_on_device:
            raise ValueError(
                "transfer_colorspace='yuv420' requires normalize_on_device "
                "(the YCbCr->RGB conversion happens in the step)")

    def pack_yuv420(self, rgb: np.ndarray) -> np.ndarray:
        """RGB uint8 (H, W, 3) -> packed I420 (H*3/2, W) uint8 (the host
        path for sources the native decoder did not handle; JFIF full
        range)."""
        h, w = rgb.shape[:2]
        f = rgb.astype(np.float32)
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
        cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b

        def sub(c):  # 2x2 box-average chroma subsampling
            return c.reshape(h // 2, 2, w // 2, 2).mean((1, 3))

        out = np.empty((h * 3 // 2, w), np.uint8)
        out[:h] = np.clip(y + 0.5, 0, 255).astype(np.uint8)
        out[h:, : w // 2] = np.clip(sub(cb) + 0.5, 0, 255).astype(np.uint8)
        out[h:, w // 2:] = np.clip(sub(cr) + 0.5, 0, 255).astype(np.uint8)
        return out

    def decode_native(self, path: str, flip: bool):
        """The image at ``path`` through the native decoder in the form this
        pipeline ships, or None where the decoder is off, unavailable or
        could not read the file."""
        if not self.native_decoder:
            return None
        from . import native_loader

        if not native_loader.available():
            return None
        if self.transfer_colorspace == "yuv420":
            return native_loader.load_image_yuv(path, self.img_size, flip=flip)
        if self.normalize_on_device:
            return native_loader.load_image_u8(path, self.img_size, flip=flip)
        return native_loader.load_image(path, self.img_size, self.mean,
                                        self.std, flip=flip)

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
        img = None
        if "image" not in item:
            img = self.decode_native(item["img_path"], do_flip)
        if img is None:
            raw = item.get("image")
            if raw is None:
                raw = self.load_image(item["img_path"])
            raw = self.resize(raw)
            if do_flip:
                raw = raw[:, ::-1]
            if self.transfer_colorspace == "yuv420":
                img = self.pack_yuv420(np.ascontiguousarray(raw))
            elif self.normalize_on_device:
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
    """Normalise uint8 image batches on their device (ImageNet mean/std).

    uint8 RGB ``(..., H, W, 3)`` is normalised; a packed I420 batch
    ``(B, H*3/2, W)`` or chart ``(H*3/2, W)`` (Y rows, then a U|V
    half-resolution strip) first has its chroma upsampled bilinearly and is
    converted from JFIF full-range YCbCr to RGB, clamped to [0, 255]. Float
    inputs pass through unchanged (already normalised on the host). Plain
    PyTorch in the JAX package's operation order: the 2x bilinear upsample
    (half-pixel centres, edge samples clamped) equals ``jax.image.resize``'s,
    whose edge weights renormalise to the same values.
    """
    if images.dtype != torch.uint8:
        return images
    mean = torch.from_numpy(IMAGENET_MEAN).to(images.device)
    std = torch.from_numpy(IMAGENET_STD).to(images.device)
    if images.shape[-1] == 3:
        return (images.to(torch.float32) - mean) / std
    squeeze = images.dim() == 2
    if squeeze:
        images = images[None]
    _, h32, w = images.shape
    h = h32 * 2 // 3
    y = images[:, :h, :].to(torch.float32)
    strip = images[:, h:, :].to(torch.float32)

    def up(c):
        return torch.nn.functional.interpolate(
            c[:, None], size=(h, w), mode="bilinear", align_corners=False,
            antialias=False)[:, 0] - 128.0

    u = up(strip[:, :, : w // 2])
    v = up(strip[:, :, w // 2:])
    rgb = torch.stack([
        y + 1.402 * v,
        y - 0.344136 * u - 0.714136 * v,
        y + 1.772 * u,
    ], dim=-1).clamp(0.0, 255.0)
    out = (rgb - mean) / std
    return out[0] if squeeze else out

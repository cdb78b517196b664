"""COCO-style spherical detection datasets (360-Indoor, PANDORA).

- annotations are COCO JSON whose ``bbox`` is a spherical box in degrees,
  theta in [0, 360), phi in [0, 180);
- BFoV boxes are 4-tuples, RBFoV 5-tuples (PANDORA); a box is cut or
  zero-padded to ``box_version``;
- categories are sorted by id and mapped to contiguous labels;
- ``iscrowd`` annotations become ignore regions (``ignore_boxes`` /
  ``ignore_labels``): no training target, no recall denominator, and a
  detection that overlaps one is neither a true nor a false positive.

Host-side, numpy only. Images are decoded on access, by the pipeline.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

# Published category list of 360-Indoor; the JSON's own categories take
# precedence when available.
INDOOR360_CLASSES = (
    "backpack", "bathtub", "bed", "board", "book", "bottle", "bowl",
    "cabinet", "chair", "clock", "computer", "cup", "door", "fan",
    "fireplace", "heater", "keyboard", "light", "microwave", "mirror",
    "mouse", "oven", "person", "phone", "picture", "potted plant",
    "refrigerator", "sink", "sofa", "table", "toilet", "towel", "tv",
    "vase", "washer", "window", "wine glass",
)


@dataclass
class SphCocoDataset:
    """COCO-style spherical dataset.

    Args:
        ann_file: path to the COCO JSON.
        img_prefix: directory holding the ERP images.
        box_version: 4 (BFoV) or 5 (RBFoV).
        classes: optional explicit class-name tuple; default = JSON order.
        filter_empty: drop images without a (non-crowd) annotation.
    """

    ann_file: str
    img_prefix: str = ""
    box_version: int = 4
    classes: tuple = ()
    filter_empty: bool = True
    _items: list = field(default_factory=list, repr=False)

    def __post_init__(self):
        with open(self.ann_file) as f:
            coco = json.load(f)
        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        if not self.classes:
            self.classes = tuple(c["name"] for c in cats)
        cat2label = {c["id"]: i for i, c in enumerate(cats)}

        per_img: dict = {}
        per_img_ignore: dict = {}
        for ann in coco.get("annotations", []):
            box = np.asarray(ann["bbox"][: self.box_version], np.float32)
            if box.shape[0] < self.box_version:
                box = np.concatenate(
                    [box, np.zeros(self.box_version - box.shape[0], np.float32)]
                )
            dst = per_img_ignore if ann.get("iscrowd", 0) else per_img
            dst.setdefault(ann["image_id"], []).append(
                (box, cat2label[ann["category_id"]])
            )

        def _stack(anns):
            boxes = (
                np.stack([a[0] for a in anns])
                if anns else np.zeros((0, self.box_version), np.float32)
            )
            return boxes, np.asarray([a[1] for a in anns], np.int32)

        for img in coco.get("images", []):
            anns = per_img.get(img["id"], [])
            if self.filter_empty and not anns:
                continue
            boxes, labels = _stack(anns)
            ig_boxes, ig_labels = _stack(per_img_ignore.get(img["id"], []))
            self._items.append({
                "img_id": img["id"],
                "file_name": img["file_name"],
                "width": img.get("width"),
                "height": img.get("height"),
                "boxes": boxes,
                "labels": labels,
                "ignore_boxes": ig_boxes,
                "ignore_labels": ig_labels,
            })

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self):
        return len(self._items)

    def __getitem__(self, idx: int) -> dict:
        item = dict(self._items[idx])
        item["img_path"] = os.path.join(self.img_prefix, item["file_name"])
        return item

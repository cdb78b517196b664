from .coco_sph import INDOOR360_CLASSES, SphCocoDataset
from .loader import (
    DataLoader,
    make_synthetic_dataset,
    prefetch_to_device,
    to_device,
)
from .pipeline import SphPipeline, maybe_normalize_images

__all__ = [
    "DataLoader",
    "INDOOR360_CLASSES",
    "SphCocoDataset",
    "SphPipeline",
    "make_synthetic_dataset",
    "maybe_normalize_images",
    "prefetch_to_device",
    "to_device",
]

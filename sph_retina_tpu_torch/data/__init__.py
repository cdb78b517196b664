from .coco_sph import INDOOR360_CLASSES, SphCocoDataset
from .loader import (
    DataLoader,
    PinnedStaging,
    make_synthetic_dataset,
    prefetch_to_device,
    to_device,
)
from .pipeline import SphPipeline, maybe_normalize_images
from .policy import resolve_transfer_colorspace

__all__ = [
    "DataLoader",
    "INDOOR360_CLASSES",
    "PinnedStaging",
    "SphCocoDataset",
    "SphPipeline",
    "make_synthetic_dataset",
    "maybe_normalize_images",
    "resolve_transfer_colorspace",
    "prefetch_to_device",
    "to_device",
]

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
from .video import VideoWriter, open_video

__all__ = [
    "DataLoader",
    "INDOOR360_CLASSES",
    "PinnedStaging",
    "SphCocoDataset",
    "SphPipeline",
    "VideoWriter",
    "make_synthetic_dataset",
    "maybe_normalize_images",
    "open_video",
    "resolve_transfer_colorspace",
    "prefetch_to_device",
    "to_device",
]

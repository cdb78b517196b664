"""Shared ERP-chart helper of the dataset converters (``pascal_voc.py``,
``cityscapes.py``): host code, no torch, so that the converters start at
once. The array counterpart is ``boxes/formator.py:pix2sph_box_transform``.
"""

from __future__ import annotations


def pix2bfov(x1, y1, x2, y2, w, h):
    """Pixel xyxy -> BFoV degrees on the image's ERP chart
    (theta = cx/W*360, phi = cy/H*180, alpha = w/W*360, beta = h/H*180 —
    the inverse of ``boxes/formator.py:sph2pix_box_transform``)."""
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    return [cx / w * 360.0, cy / h * 180.0,
            (x2 - x1) / w * 360.0, (y2 - y1) / h * 180.0]

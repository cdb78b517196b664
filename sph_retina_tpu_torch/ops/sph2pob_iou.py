"""Pairwise fused Sph2Pob IoU: wrapper of the CUDA kernel.

``sph2pob_iou_pairwise(boxes1, boxes2)`` computes the (N, M) IoU matrix of
two sets of spherical boxes in degrees. On CUDA tensors it launches the
hand-written kernel of ``csrc/sph2pob_iou.cu`` (built at first use by
``_build.py``) or raises; on CPU tensors — and only because they lie on the
CPU — it takes the plain version, ``fused_iou.sph2pob_iou_pairwise_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_iou import sph2pob_iou_pairwise_plain

_LIB_NAME = "sph2pob_iou"


def _launcher():
    lib = _build.load_library(_LIB_NAME)
    fn = lib.sph2pob_iou_pairwise_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sph2pob_iou_pairwise(boxes1: torch.Tensor,
                         boxes2: torch.Tensor) -> torch.Tensor:
    """Fused pairwise Sph2Pob IoU matrix: (N, D) x (M, D) degrees -> (N, M).

    Both inputs must be fp32, contiguous, on one device, with D equal and 4
    (theta, phi, alpha, beta) or 5 (+ gamma). The kernel runs on the current
    CUDA stream and the call does not synchronise. Every kernel launch adds
    one to ``sph2pob_iou_pairwise.launches``.
    """
    for name, b in (("boxes1", boxes1), ("boxes2", boxes2)):
        if not isinstance(b, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(b)}")
        if b.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {b.dtype}")
        if b.ndim != 2 or b.shape[1] not in (4, 5):
            raise ValueError(
                f"{name} must be (N, 4) or (N, 5), got {tuple(b.shape)}")
        if not b.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if boxes1.shape[1] != boxes2.shape[1]:
        raise ValueError(
            f"box widths differ: {boxes1.shape[1]} vs {boxes2.shape[1]}")
    if boxes1.device != boxes2.device:
        raise ValueError(
            f"boxes lie on different devices: {boxes1.device}, {boxes2.device}")

    if boxes1.device.type == "cpu":
        return sph2pob_iou_pairwise_plain(boxes1, boxes2)
    if boxes1.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes1.device}")

    n, d = boxes1.shape
    m = boxes2.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=boxes1.device)
    if n == 0 or m == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(boxes1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(boxes1.data_ptr(), boxes2.data_ptr(), out.data_ptr(),
                     n, m, d, stream)
    if err != 0:
        raise RuntimeError(
            f"sph2pob_iou_pairwise: kernel launch failed with CUDA error "
            f"{err} for shapes {tuple(boxes1.shape)} x {tuple(boxes2.shape)}")
    sph2pob_iou_pairwise.launches += 1
    return out


sph2pob_iou_pairwise.launches = 0

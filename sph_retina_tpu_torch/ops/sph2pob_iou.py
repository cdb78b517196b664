"""Fused Sph2Pob IoU: the two CUDA kernels as ``torch.library`` custom ops.

``sph2pob_iou_pairwise(boxes1, boxes2)`` computes the (N, M) IoU matrix of
two sets of spherical boxes in degrees, ``sph2pob_iou_aligned(boxes1,
boxes2)`` the (N,) IoUs of N matched pairs. Each checks its arguments and
calls its op, ``torch.ops.sph_retina.sph2pob_iou_pairwise`` /
``torch.ops.sph_retina.sph2pob_iou_aligned``. The op's CUDA kernel launches
the hand-written kernel — ``csrc/sph2pob_iou.cu`` and
``csrc/sph2pob_iou_aligned.cu``, two libraries built at first launch by
``_build.py``, each source on its own so that they compile side by side, and
bound with ``ctypes`` — or raises; its CPU kernel, taken only because the
tensors lie on the CPU, is the plain version in ``fused_iou.py``. A fake
kernel gives the output's shape, so that ``torch.export`` keeps each op as
one node of the graph, and an exported program launches the kernel when it
is called. Importing this module registers the ops; nothing is built then.
Neither op has a gradient, as the kernels they replace have none.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_iou import sph2pob_iou_aligned_plain, sph2pob_iou_pairwise_plain

_PAIRWISE_LIB = "sph2pob_iou"
_ALIGNED_LIB = "sph2pob_iou_aligned"


def _pairwise_launcher():
    fn = _build.load_library(_PAIRWISE_LIB).sph2pob_iou_pairwise_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned_launcher():
    fn = _build.load_library(_ALIGNED_LIB).sph2pob_iou_aligned_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_boxes(boxes1, boxes2) -> None:
    """What both kernels take: fp32, contiguous, (N, 4 | 5), one width, one
    device, CPU or CUDA."""
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
    if boxes1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {boxes1.device}")


@torch.library.custom_op("sph_retina::sph2pob_iou_pairwise", mutates_args=(),
                         device_types="cpu")
def _pairwise_op(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    return sph2pob_iou_pairwise_plain(boxes1, boxes2)


@_pairwise_op.register_kernel("cuda")
def _pairwise_cuda(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    n, d = boxes1.shape
    m = boxes2.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=boxes1.device)
    if n == 0 or m == 0:
        return out
    launch = _pairwise_launcher()
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


@_pairwise_op.register_fake
def _pairwise_fake(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    return boxes1.new_empty((boxes1.shape[0], boxes2.shape[0]),
                            dtype=torch.float32)


@torch.library.custom_op("sph_retina::sph2pob_iou_aligned", mutates_args=(),
                         device_types="cpu")
def _aligned_op(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    return sph2pob_iou_aligned_plain(boxes1, boxes2)


@_aligned_op.register_kernel("cuda")
def _aligned_cuda(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    n, d = boxes1.shape
    out = torch.empty((n,), dtype=torch.float32, device=boxes1.device)
    if n == 0:
        return out
    launch = _aligned_launcher()
    with torch.cuda.device(boxes1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(boxes1.data_ptr(), boxes2.data_ptr(), out.data_ptr(),
                     n, d, stream)
    if err != 0:
        raise RuntimeError(
            f"sph2pob_iou_aligned: kernel launch failed with CUDA error "
            f"{err} for shape {tuple(boxes1.shape)}")
    sph2pob_iou_aligned.launches += 1
    return out


@_aligned_op.register_fake
def _aligned_fake(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    return boxes1.new_empty((boxes1.shape[0],), dtype=torch.float32)


def sph2pob_iou_pairwise(boxes1: torch.Tensor,
                         boxes2: torch.Tensor) -> torch.Tensor:
    """Fused pairwise Sph2Pob IoU matrix: (N, D) x (M, D) degrees -> (N, M).

    Both inputs must be fp32, contiguous, on one device, with D equal and 4
    (theta, phi, alpha, beta) or 5 (+ gamma). The kernel runs on the current
    CUDA stream and the call does not synchronise. Every kernel launch adds
    one to ``sph2pob_iou_pairwise.launches``, also a launch from an exported
    program.
    """
    _check_boxes(boxes1, boxes2)
    return _pairwise_op(boxes1, boxes2)


sph2pob_iou_pairwise.launches = 0


def sph2pob_iou_aligned(boxes1: torch.Tensor,
                        boxes2: torch.Tensor) -> torch.Tensor:
    """Fused aligned Sph2Pob IoU: (N, D), (N, D) degrees -> (N,) in [0, 1].

    ``out[i]`` is the IoU of ``boxes1[i]`` and ``boxes2[i]``. Both inputs
    must be fp32, contiguous, on one device, of one shape, with D 4 or 5. No
    gradient flows through the call (the kernel it replaces has none). The
    kernel runs on the current CUDA stream and the call does not synchronise.
    Every kernel launch adds one to ``sph2pob_iou_aligned.launches``.
    """
    _check_boxes(boxes1, boxes2)
    if boxes1.shape[0] != boxes2.shape[0]:
        raise ValueError(
            f"aligned IoU needs as many boxes on both sides, got "
            f"{boxes1.shape[0]} and {boxes2.shape[0]}")
    with torch.no_grad():
        return _aligned_op(boxes1, boxes2)


sph2pob_iou_aligned.launches = 0

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --fmad-probe # also: K1 built with FMA contraction
    python3 chip_smoke.py --assign-probe  # only: the eager sph2pob_standard
                                          # assignment at the R50 width

Drives the main paths of ``sph_retina_tpu_torch`` the way a user would, at
full width: on the shipped rotated RetinaNet-R50-FPN config (47 classes,
512x1024, bf16, 5-dof boxes) the HTTP server (``/ping`` and a few
``/predict`` requests) and the trainer (``train.main``, a few optimiser steps
at batch 4); on the shipped Sphere-bench config (R18, 256x512, batch 8,
decoded-box Sph2Pob-CIoU loss) the trainer again; on the shipped PANDORA
RetinaNet config (R50, 4-dof boxes, ``unbiased_iou`` NMS) one request through
the server; the trainer on the shipped SSD-VGG16, Kent-KLD, 5-dof Kent and
FCOS-R50 configs and one ``inference_detector`` request each to the FCOS, SSD
and Kent-KLD configs; the trainer on three Faster R-CNN configs (R50
indoor360 with the random and the OHEM RoI sampler, R18 Sphere-bench) and
one request to the soft-NMS one; the training workflow on a COCO-style set;
the export of the rotated config and the deployment evaluation of its
artifact; the production input path (native decoder or PIL, packed-I420
transfer, the ``auto`` policy, copies on a stream of their own, the
evaluation's OOM ladder) on 960x1920 panoramas; and the IoU tool (``benchmark_iou.main``,
the kernel and the other backends) — and holds every CUDA kernel of those
paths against its plain PyTorch version on the card.

Phases, each printing one JSON line; any failure ends the run non-zero:

1. device   name, and name + power limit as nvidia-smi gives them
2. build    every kernel library from ``sph_retina_tpu_torch/csrc`` with nvcc,
            side by side
3. kernels  each kernel vs its plain version at the shapes its paths give it
            (max abs difference <= 1e-4, values finite and in [0, 1]), timed
            with CUDA events (median after warm-up), beside its bound; the
            share of pairs the kernel culls (``sph2pob_disjoint_plain``),
            whose plain IoU must be 0.0
4. iou_tool the IoU tool runs the aligned kernel (launch counter set to 0
            before, read after), then the seven ``--backends`` rows with their
            errors against the unbiased oracle
5. serve    the server answers the requests through the pairwise kernel, the
            records are well formed, and swapping the plain version in keeps
            the same boxes; the kernel is checked and timed as in phase 3 on
            the NMS candidates of the last request;
   breakdown  where a steady request's time goes (events, host clock, profiler)
6. train    ``train.main`` takes 6 steps at full width: finite losses, one
            launch of the pairwise kernel a step at (256, 98208); then, on a
            fixed batch with warm-up off, the loss falls over 6 steps, the
            plain version in the kernel's place gives the same labels, and a
            step's time, memory and device share are read; the kernel is
            checked and timed as in phase 3 on the batch's assignment input
7. train_iou_loss  ``train.main`` on the Sphere-bench config: finite,
            positive ``loss_bbox`` every step, one launch of the pairwise
            kernel a step at (192, 24552), the kernel checked on the last
            step's input; step time beside the L1 step of the same config,
            where it goes, memory, device share
8. serve_unbiased  one request to the PANDORA config's server, whose NMS
            takes the unbiased oracle (plain PyTorch): ms and memory
9. train_ssd  ``train.main`` on the SSD-VGG16 config: one launch of the
            pairwise kernel a step at (256, 49056) D=4, the kernel bitwise
            equal to its plain version on the last step's input; a fixed
            batch's step time, memory, device share
10. train_kent  ``train.main`` on the Kent-KLD config (every loss finite),
            its Kent assignment alone (time, device time, memory), then two
            steps of the 5-dof Kent config with delta-L1
11. train_fcos  ``train.main`` on the FCOS-R50 config, then a fixed batch:
            step time, ``loss_centerness``, memory, device share
12. serve_families  one ``inference_detector`` request each to the FCOS,
            SSD and Kent-KLD configs: non-empty, well-formed results
13. train_frcnn  ``train.main`` on the Faster R-CNN R50 indoor360 config:
            one launch of the pairwise kernel a step at (256, 130944) D=4
            and four at the RoI sampler's (64, 576), bitwise equal to the
            plain version on the last step's inputs at both; a fixed batch
            (step time, memory, device share, the RPN NMS's sweeps); one
            step of the OHEM leaf, two of the R18 Sphere-bench leaf; one
            request to the soft-NMS leaf (scores decayed, boxes kept that
            hard NMS removes)
14. train_coco  the training workflow on a COCO-style set it writes: two
            epochs with an evaluation and a checkpoint each, a resume, the
            test CLI, publishing
15. export  the rotated config exported at batch 1 (``torch.export``; the
            seconds of export, save and load, the artifact's bytes), the
            artifact against the live predict on 3 images (labels, validity,
            indices equal; boxes, scores within 1e-5), one K1 launch an
            image from the artifact, its ms an image beside the live
            predict's; ``deployment_test.main`` on the artifact over 8 val
            images against ``evaluate_dataset`` (metrics within 1e-3); the
            custom op's dispatch cost a K1 call
16. train_input  the production input path: the rotated config trains 4
            steps with one evaluation of 4 images on 960x1920 panoramas
            (JPEGs and one PNG) it writes, through ``train.main``, four
            times: ``rgb`` with the native decoder (PIL where it cannot be
            built: ``native_decoder`` line, the compiler's reason), ``rgb``
            with PIL, ``yuv420``, ``auto``; per run the loader's images a
            second, a batch's bytes and H2D ms, step ms, a profiled
            two-step window's busy share and streams, the evaluation's s,
            the ``auto`` probes. Gates: every image of a native run read by
            the decoder; K1 once a step and once a val image; the I420
            batch within the JAX test's bound of the RGB batch on the card;
            the card's conversion within 1e-4 of the CPU's; the image
            batches' copies on another stream than the compute stream; an
            injected OOM climbing ``AvoidOOM``'s gc and bf16 rungs
17. the kernels' summary line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``

Weights are random, made from ``--seed``; no number printed here says
anything about detection quality. Needs no network; exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sph_retina_tpu_torch import benchmark_iou
from sph_retina_tpu_torch import deployment_test as deployment_cli
from sph_retina_tpu_torch import export as export_cli
from sph_retina_tpu_torch import publish as publish_cli
from sph_retina_tpu_torch import test as test_cli
from sph_retina_tpu_torch import train as train_cli
from sph_retina_tpu_torch.apis import inference_detector, init_detector
from sph_retina_tpu_torch.boxes import nms as nms_module
from sph_retina_tpu_torch.engine import evaluator, runner
from sph_retina_tpu_torch.engine.builder import build_datasets
from sph_retina_tpu_torch.engine.eval import eval_spherical_map
from sph_retina_tpu_torch.data import (
    PinnedStaging,
    SphCocoDataset,
    SphPipeline,
    native_loader,
    policy,
    prefetch_to_device,
    to_device,
)
from sph_retina_tpu_torch.data.pipeline import (
    IMAGENET_STD,
    maybe_normalize_images,
)
from sph_retina_tpu_torch.losses import (
    sph2pob_iou_loss,
    sph_kent_loss,
    sph_l1_loss,
)
from sph_retina_tpu_torch.models import faster_rcnn, single_stage
from sph_retina_tpu_torch.ops import _build, fused_iou
from sph_retina_tpu_torch.ops.fused_iou import (
    sph2pob_disjoint_plain,
    sph2pob_iou_aligned_plain,
    sph2pob_iou_pairwise_plain,
)
from sph_retina_tpu_torch.ops.sph2pob_iou import (
    sph2pob_iou_aligned,
    sph2pob_iou_pairwise,
)
from sph_retina_tpu_torch.serve import make_handler
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config
from sph_retina_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs",
                      "sph_rotated_retinanet_r50_fpn_120e_pandora.py")
IOU_CONFIG = os.path.join(ROOT, "configs",
                          "sph_retinanet_r18_fpn_24e_spherebench.py")
UNBIASED_CONFIG = os.path.join(ROOT, "configs",
                               "sph_retinanet_r50_fpn_120e_pandora.py")
STANDARD_ASSIGN_CONFIG = os.path.join(
    ROOT, "configs", "sph_retinanet_r50_fpn_120e_indoor360.py")
SSD_CONFIG = os.path.join(ROOT, "configs", "sph_ssd_vgg16_120e_indoor360.py")
KENT_KLD_CONFIG = os.path.join(ROOT, "configs",
                               "sph_kent_retinanet_kld_120e_indoor360.py")
KENT_L1_CONFIG = os.path.join(ROOT, "configs",
                              "sph_kent_retinanet_r50_fpn_120e_indoor360.py")
FCOS_CONFIG = os.path.join(ROOT, "configs",
                           "sph_fcos_r50_fpn_120e_indoor360.py")
FRCNN_CONFIG = os.path.join(ROOT, "configs",
                            "sph_faster_rcnn_r50_fpn_120e_indoor360.py")
FRCNN_OHEM_CONFIG = os.path.join(
    ROOT, "configs", "sph_faster_rcnn_r50_fpn_ohem_120e_indoor360.py")
FRCNN_SOFT_CONFIG = os.path.join(
    ROOT, "configs", "sph_faster_rcnn_r50_fpn_soft_nms_120e_indoor360.py")
FRCNN_R18_CONFIG = os.path.join(
    ROOT, "configs", "sph_faster_rcnn_r18_fpn_24e_spherebench.py")
TOLERANCE = 1e-4  # the JAX suite's own tolerance for its Pallas kernels
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and the fp32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
N_REQUESTS = 3
TRAIN_STEPS = 6
TRAIN_BATCH = 4  # samples_per_gpu of the shipped config
IOU_TOOL_ITERS = 10
IOU_TRAIN_STEPS = 4
IOU_TRAIN_BATCH = 8  # samples_per_gpu of the Sphere-bench config
TOOL_BACKENDS = ("sph2pob_efficient", "sph2pob_standard", "sph2pob_legacy",
                 "sph", "fov", "naive", "unbiased")
TOOL_BACKENDS_SIZE = 100_000
N_UNBIASED_REQUESTS = 2
UNBIASED_IMG_SIZE = (512, 1024)
SSD_TRAIN_STEPS = 4
SSD_TRAIN_BATCH = 4      # samples_per_gpu of the indoor360 leaf
KENT_TRAIN_STEPS = 3     # the Kent-KLD config, batch 1
KENT_L1_STEPS = 2        # the Kent config with delta-L1, 5-dof, batch 1
FCOS_TRAIN_STEPS = 3
FCOS_TRAIN_BATCH = 4
FRCNN_TRAIN_STEPS = 3    # the indoor360 R50 leaf through train.main
FRCNN_FIXED_STEPS = 6    # then on a fixed batch
FRCNN_TRAIN_BATCH = 4
FRCNN_R18_STEPS = 2      # the Sphere-bench R18 leaf, batch 8


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------------- #
def seeded_boxes(n: int, d: int, rng: np.random.Generator) -> np.ndarray:
    """Uniform random spherical boxes in degrees."""
    cols = [rng.uniform(0.0, 360.0, n), rng.uniform(0.0, 180.0, n),
            rng.uniform(1.0, 100.0, n), rng.uniform(1.0, 100.0, n)]
    if d == 5:
        cols.append(rng.uniform(-90.0, 90.0, n))
    return np.stack(cols, axis=1).astype(np.float32)


def _touching_cells(d: int) -> np.ndarray:
    """A grid of 30-degree cells that touch along exact meridians and
    parallels on both sides."""
    return np.array([[t, p, 30.0, 30.0] + [0.0] * (d - 4)
                     for t in np.arange(30.0, 180.0, 30.0)
                     for p in np.arange(45.0, 135.0, 30.0)], np.float32)


def pairwise_inputs(shape, seed: int):
    """Two seeded box sets with degenerate pairs mixed in: bitwise-identical
    boxes on the leading diagonal and, where there is room, the touching
    cells against each other."""
    n, m, d = shape
    rng = np.random.default_rng(seed)
    b1, b2 = seeded_boxes(n, d, rng), seeded_boxes(m, d, rng)
    k = max(1, min(n, m) // 8)
    b2[:k] = b1[:k]
    cells = _touching_cells(d)
    if min(n, m) >= k + len(cells):
        b1[k:k + len(cells)] = cells
        b2[k:k + len(cells)] = cells
    return b1, b2


def aligned_inputs(shape, seed: int):
    """N seeded pairs with degenerate ones mixed in: the first eighth
    bitwise identical and, where there is room, each touching cell paired
    with itself and with its neighbour."""
    n, d = shape
    rng = np.random.default_rng(seed)
    b1, b2 = seeded_boxes(n, d, rng), seeded_boxes(n, d, rng)
    k = max(1, n // 8)
    b2[:k] = b1[:k]
    cells = _touching_cells(d)
    if n >= k + 2 * len(cells):
        b1[k:k + 2 * len(cells)] = np.concatenate([cells, cells])
        b2[k:k + 2 * len(cells)] = np.concatenate(
            [cells, np.roll(cells, 1, axis=0)])
    return b1, b2


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, how it is
    called, and the shapes its paths give it."""

    name: str            # the wrapper's name
    library: str         # csrc/<library>.cu, one shared library
    replaces: str        # file:line of the TPU kernel
    device_name: str     # substring of the kernel's name in a profile
    wrapper: Callable
    plain: Callable
    culled: Callable     # (boxes1, boxes2) -> the pairs the kernel culls
    shapes: tuple        # pairwise (N, M, D); aligned (N, D)
    main_shape: tuple    # the one the summary line's times are for
    inputs: Callable     # (shape, seed) -> two numpy box sets
    out_shape: Callable  # shape -> the output's shape
    n_bytes: Callable    # shape -> bytes moved: inputs read once, output written
    identical: Callable  # (output, shape) -> IoUs of the identical pairs
    pairwise: bool

    @property
    def source(self) -> str:
        return f"sph_retina_tpu_torch/csrc/{self.library}.cu"


SERVING_SHAPE = (1000, 1000, 5)       # (N, M, D), once per served image
ASSIGN_SHAPE = (256, 98208, 5)        # batch 4 x max_gt 64 against the anchors
IOU_ASSIGN_SHAPE = (192, 24552, 4)    # Sphere-bench: batch 8 x max_gt 24
SSD_ASSIGN_SHAPE = (256, 49056, 4)    # SSD-VGG16: batch 4 x max_gt 64
KENT_ASSIGN_PAIRS = (64, 98208)       # Kent-KLD: batch 1 x max_gt 64
# Faster R-CNN indoor360: the RPN's batch 4 x max_gt 64 against the 130,944
# anchors of strides 4-64, and the RoI sampler's max_gt x (512 proposals +
# 64 gts), one launch a image; the R18 Sphere-bench leaf: batch 8 x max_gt 24
# against 32,736 anchors, and 24 x (512 + 24)
FRCNN_RPN_SHAPE = (256, 130944, 4)
FRCNN_ROI_SHAPE = (64, 576, 4)
FRCNN_R18_RPN_SHAPE = (192, 32736, 4)
FRCNN_R18_ROI_SHAPE = (24, 536, 4)
FRCNN_LEAF = (50, 37, (512, 1024))         # depth, classes, img_size
FRCNN_R18_LEAF = (18, 12, (256, 512))
TOOL_SHAPE = (1_000_000, 4)           # the IoU tool's default
KERNELS = (
    Kernel(
        name="sph2pob_iou_pairwise", library="sph2pob_iou",
        replaces="sph_retina_tpu/ops/pallas_iou.py:134",
        device_name="pairwise_kernel",
        wrapper=sph2pob_iou_pairwise, plain=sph2pob_iou_pairwise_plain,
        culled=lambda b1, b2: sph2pob_disjoint_plain(b1[:, None], b2[None]),
        # serving, ragged edges, half the assignment rows at D=4, assignment
        shapes=(SERVING_SHAPE, (1000, 1000, 4), (7, 5, 5), (129, 257, 4),
                (128, 98208, 4), ASSIGN_SHAPE),
        main_shape=SERVING_SHAPE,
        inputs=pairwise_inputs,
        out_shape=lambda s: (s[0], s[1]),
        n_bytes=lambda s: 4 * ((s[0] + s[1]) * s[2] + s[0] * s[1]),
        identical=lambda out, s: out.diagonal()[:max(1, min(s[0], s[1]) // 8)],
        pairwise=True,
    ),
    Kernel(
        name="sph2pob_iou_aligned", library="sph2pob_iou_aligned",
        replaces="sph_retina_tpu/ops/pallas_iou.py:81",
        device_name="aligned_kernel",
        wrapper=sph2pob_iou_aligned, plain=sph2pob_iou_aligned_plain,
        culled=sph2pob_disjoint_plain,
        shapes=tuple((n, d) for d in (4, 5)
                     for n in (1, 130, 98208, 1_000_000)),
        main_shape=TOOL_SHAPE,
        inputs=aligned_inputs,
        out_shape=lambda s: (s[0],),
        n_bytes=lambda s: 4 * (2 * s[0] * s[1] + s[0]),
        identical=lambda out, s: out[:max(1, s[0] // 8)],
        pairwise=False,
    ),
)


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Weights made with numpy from a seed: He-normal conv and dense
    kernels, batch norms at identity except the last one of each residual
    block (scale 0.3, so that activations do not grow 2x a block), biases 0
    — the focal prior of ``retina_cls`` included, or no score would pass
    ``score_thr``."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        if len(shape) in (2, 4):  # conv and dense kernels
            fan_in = math.prod(shape[1:])
            value = rng.standard_normal(shape, dtype=np.float32) \
                * math.sqrt(2.0 / fan_in)
        elif key.endswith("running_var"):
            value = np.ones(shape, np.float32)
        elif key.endswith(("running_mean", "bias")):
            value = np.zeros(shape, np.float32)
        else:  # batch-norm scale
            value = np.full(shape, 0.3 if key.endswith("bn3.weight") else 1.0,
                            np.float32)
        state[key] = torch.from_numpy(value)
    return state


@torch.no_grad()
def calibrate_head(det, image: np.ndarray, cls_std=2.0, reg_std=0.3) -> dict:
    """Rescale the two output convs so that, on a seeded image, the logits
    have standard deviation ``cls_std`` and the box deltas ``reg_std``:
    random towers otherwise give outputs of arbitrary scale, and every box
    would sit on the coder's clamps."""
    x = torch.from_numpy(image[None]).to(det.device)
    cls, reg = det.model(maybe_normalize_images(x))
    before = {"cls_std": float(torch.cat([c.flatten() for c in cls]).std()),
              "reg_std": float(torch.cat([r.flatten() for r in reg]).std())}
    head = det.model.bbox_head
    head.retina_cls.weight.mul_(cls_std / before["cls_std"])
    head.retina_reg.weight.mul_(reg_std / before["reg_std"])
    return before


# --------------------------------------------------------------------------- #
# measuring
# --------------------------------------------------------------------------- #
def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over ``reps`` launches of ``fn``, each between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, reps: int) -> float:
    """Milliseconds a launch when ``reps`` launches are enqueued between one
    pair of CUDA events: what a launch costs once the queue is full, without
    the events' own latency that ``median_ms`` carries on small kernels."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, top: int = 10) -> dict:
    """One profiled call of ``fn``: wall time, device time by kernel name
    (device-side events only: operator rows repeat their kernels' time), the
    device's idle share of the wall time, each hand-written kernel's time
    and launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    by_kernel, launches_by_kernel = {}, {}
    for k in KERNELS:
        own = [(us, n) for key, us, n in rows if k.device_name in key]
        if own:
            by_kernel[k.name] = sum(us for us, _ in own) / 1e3
            launches_by_kernel[k.name] = sum(n for _, n in own)
    return {
        "wall_ms": wall_us / 1e3,
        "device_ms": device_us / 1e3 if rows else None,
        "device_idle_share": 1.0 - device_us / wall_us if rows else None,
        "kernel_launches": sum(r[2] for r in rows),
        "top_device_ms": [
            {"name": k[:60], "ms": us / 1e3, "calls": n}
            for k, us, n in sorted(rows, key=lambda r: -r[1])[:top]],
        "ms_by_kernel": by_kernel,
        "launches_by_kernel": launches_by_kernel,
    }


class _OpCounter(TorchDispatchMode):
    """Counts tensor operations (views and ``zeros_like`` left out) by the
    number of elements of their result."""

    def __init__(self):
        super().__init__()
        self.by_numel = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and not func.is_view \
                and "zeros_like" not in str(func):
            self.by_numel[out.numel()] += 1
        return out


def stage_ops(kernel: Kernel, d: int) -> dict:
    """Elementwise fp32 operations (arithmetic, compare, select, sin/cos,
    sqrt, each counted once) of each stage of the kernels' body, counted on
    the plain version's stages (``ops/fused_iou.py``): the pair's jitter
    flag, one box's state on each side with its cull radius (``side1``,
    ``side2``), the cull and the body. For the pairwise kernel the states
    are counted on 6 and 7 boxes alone, as the kernel makes them (two a box,
    one for each jitter state); for the aligned one on 42 pairs, as it makes
    them (one a box, the state its pair's flag selects)."""
    rng = np.random.default_rng(0)
    if kernel.pairwise:
        n1, n2, pairs = 6, 7, 42
        b1 = torch.from_numpy(seeded_boxes(n1, d, rng))[:, None]
        b2 = torch.from_numpy(seeded_boxes(n2, d, rng))[None]
    else:
        n1 = n2 = pairs = 42
        b1 = torch.from_numpy(seeded_boxes(pairs, d, rng))
        b2 = torch.from_numpy(seeded_boxes(pairs, d, rng))
    b1 = [b1[..., c] for c in range(d)]
    b2 = [b2[..., c] for c in range(d)]
    counts = {}

    def count(name, numel, fn):
        with _OpCounter() as counter:
            out = fn()
        counts[name] = counts.get(name, 0) + counter.by_numel[numel]
        return out

    flag = count("flag", pairs, lambda: fused_iou.jitter_flag(b1, b2))
    if kernel.pairwise:
        flag = torch.tensor(False)  # a state of each box alone
    s1 = count("side1", n1, lambda: fused_iou.side_state(b1, 1, flag))
    s2 = count("side2", n2, lambda: fused_iou.side_state(b2, 2, flag))
    r1 = count("side1", n1, lambda: fused_iou.cull_radius(s1))
    r2 = count("side2", n2, lambda: fused_iou.cull_radius(s2))
    count("cull", pairs, lambda: fused_iou.disjoint(s1, r1, s2, r2))
    count("body", pairs, lambda: fused_iou.pair_body(s1, s2))
    return counts


def bound_ms(kernel: Kernel, shape, n_culled: int) -> tuple[float, str, dict]:
    """The least time the card could take for the work these inputs need:
    the larger of bytes moved (each input read once, the output written
    once) over the memory rate, and operations over the fp32 rate. The
    operations: each box's states (the pairwise kernel: both jitter states
    of every box; the aligned one: one state of each box a pair), the flag
    and the cull of every pair, and the body of the pairs that the cull
    leaves (a culled pair's IoU is 0.0 without it)."""
    d = shape[-1]
    pairs = math.prod(kernel.out_shape(shape))
    ops = stage_ops(kernel, d)
    if kernel.pairwise:
        per_box = 2 * (shape[0] * ops["side1"] + shape[1] * ops["side2"])
        per_pair = ops["flag"] + ops["cull"]
    else:
        per_box = 0
        per_pair = ops["flag"] + ops["side1"] + ops["side2"] + ops["cull"]
    n_ops = per_box + per_pair * pairs + ops["body"] * (pairs - n_culled)
    n_bytes = kernel.n_bytes(shape)
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    detail = {"bytes": n_bytes, "operations": n_ops,
              "bytes_ms": by_bytes, "operations_ms": by_ops}
    return max(by_bytes, by_ops), \
        ("operations" if by_ops >= by_bytes else "bytes"), detail


def check_kernel(kernel: Kernel, b1: torch.Tensor, b2: torch.Tensor,
                 reps: int, identical: bool = True) -> dict:
    """The kernel against its plain version on two box sets on the card:
    output shape and range, equality (max abs difference), the identical
    pairs' IoU where the inputs were seeded with them, the culled share,
    and times beside the bound."""
    shape = (b1.shape[0], b2.shape[0], b1.shape[1]) if kernel.pairwise \
        else tuple(b1.shape)
    got = kernel.wrapper(b1, b2)
    torch.cuda.synchronize()
    want = kernel.plain(b1, b2)
    torch.cuda.synchronize()
    at = f"{kernel.name} at {tuple(shape)}"
    if tuple(got.shape) != kernel.out_shape(shape) \
            or got.dtype != torch.float32:
        raise AssertionError(f"{at}: output {tuple(got.shape)} {got.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{at}: non-finite IoU")
    lo, hi = float(got.min()), float(got.max())
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"{at}: IoU outside [0, 1]: {lo}, {hi}")
    ident = None
    if identical:
        ident = float(kernel.identical(got, shape).min())
        if ident <= 0.9:  # boxes down to 1 degree wide, jittered by 0.007
            raise AssertionError(f"{at}: identical boxes give IoU {ident}")
    err = float((got - want).abs().max())
    if not err <= TOLERANCE:
        raise AssertionError(
            f"{at}: kernel differs from its plain version by {err}")
    culled = kernel.culled(b1, b2)
    if not bool((want[culled] == 0.0).all()):
        raise AssertionError(f"{at}: the cull takes pairs whose IoU is not 0")
    n_culled = int(culled.sum())
    del want, culled
    pairs = math.prod(kernel.out_shape(shape))
    ms = median_ms(lambda: kernel.wrapper(b1, b2), reps)
    queued = back_to_back_ms(lambda: kernel.wrapper(b1, b2), reps)
    # the kernel's own time on the device, free of launch and event latency,
    # from a profile of five launches
    prof = profiled(lambda: [kernel.wrapper(b1, b2) for _ in range(5)])
    n_prof = prof["launches_by_kernel"].get(kernel.name, 0)
    on_device = prof["ms_by_kernel"][kernel.name] / n_prof if n_prof else None
    plain = median_ms(lambda: kernel.plain(b1, b2),
                      max(5, reps // 4) if pairs > 4_000_000 else reps,
                      warmup=1)
    bound, by, detail = bound_ms(kernel, shape, n_culled)
    return {"shape": list(shape), "max_abs_err": err,
            "bitwise_equal": err == 0.0, "min_identical_iou": ident,
            "culled_share": n_culled / pairs,
            "kernel_ms": ms, "kernel_ms_back_to_back": queued,
            "kernel_device_ms": on_device,
            "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, **detail}


def check_kernel_shape(kernel: Kernel, shape, seed: int, reps: int) -> dict:
    """``check_kernel`` on seeded inputs of one of the kernel's shapes."""
    b1, b2 = (torch.from_numpy(b).cuda() for b in kernel.inputs(shape, seed))
    return check_kernel(kernel, b1, b2, reps)


def fmad_probe(seed: int, reps: int) -> dict:
    """The same source built WITH FMA contraction (nvcc's default), held
    against the plain version and timed beside the shipped build."""
    flags = tuple(f for f in _build.NVCC_FLAGS if f != "-fmad=false")
    path, seconds, _ = _build.build_library(
        "sph2pob_iou", os.path.join(_build.DEFAULT_BUILD_DIR, "fmad_probe"),
        flags=flags)
    fn = ctypes.CDLL(path).sph2pob_iou_pairwise_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + \
        [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {"build_seconds": seconds, "shapes": []}
    for n, m, d in (SERVING_SHAPE, (128, 98208, 4)):
        b1_np, b2_np = pairwise_inputs((n, m, d), seed)
        b1 = torch.from_numpy(b1_np).cuda()
        b2 = torch.from_numpy(b2_np).cuda()
        res = torch.empty((n, m), dtype=torch.float32, device="cuda")

        def contracted():
            err = fn(b1.data_ptr(), b2.data_ptr(), res.data_ptr(), n, m, d,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        contracted()
        torch.cuda.synchronize()
        diff = (res - sph2pob_iou_pairwise_plain(b1, b2)).abs()
        k = max(1, min(n, m) // 8)
        generic = diff.clone()
        generic[:k + 15, :k + 15] = 0.0
        times = {"contracted_ms": [], "shipped_ms": []}
        for _ in range(2):  # in turns, on one card
            times["shipped_ms"].append(
                median_ms(lambda: sph2pob_iou_pairwise(b1, b2), reps))
            times["contracted_ms"].append(median_ms(contracted, reps))
        out["shapes"].append({
            "shape": [n, m, d], "max_abs_err": float(diff.max()),
            "max_abs_err_generic_pairs": float(generic.max()),
            "pairs_over_tolerance": int((diff > TOLERANCE).sum()), **times})
    return out


def assign_probe(seed: int) -> dict:
    """The indoor360 leaf's anchor assignment, whose backend is
    ``sph2pob_standard`` (eager plain PyTorch through ``sph_overlaps``, no
    kernel), at the config's full width: one synthetic batch (4 x max_gt 64)
    against the 98,208 anchors of 512x1024. Its peak memory and time, or,
    where it does not fit on the card, the error that says so."""
    device = resolve_device()
    cfg = apply_overrides(load_config(STANDARD_ASSIGN_CONFIG),
                          ["data.n_synthetic=4"])
    _, det_cfg, loader, _, _ = train_cli.build_training(cfg, device, seed)
    (host_batch,) = list(loader.epoch(0))
    gt = torch.from_numpy(host_batch["gt_boxes"]).to(device)
    anchors = det_cfg.flat_anchors(device)
    out = {"config": os.path.relpath(STANDARD_ASSIGN_CONFIG, ROOT),
           "backend": det_cfg.assign_backend,
           "pairs": [gt.shape[0] * gt.shape[1], anchors.shape[0]]}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            overlaps = single_stage._batch_pairwise_iou(
                gt, anchors, det_cfg.assign_backend)
            torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["finite"] = bool(torch.isfinite(overlaps).all())
        out["shape"] = list(overlaps.shape)
        del overlaps
    except torch.cuda.OutOfMemoryError as err:
        out["did_not_fit"] = str(err).splitlines()[0]
    out["peak_memory_bytes_above_inputs"] = \
        torch.cuda.max_memory_allocated() - base
    out["device_memory_bytes"] = torch.cuda.get_device_properties(
        device).total_memory
    return out


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def phase_device() -> tuple[str, str]:
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return kind, smi


def phase_build() -> None:
    """Every kernel library, one nvcc each, all started together."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(lambda k: _build.build_library(k.library),
                              KERNELS))
    emit({"phase": "build", "flags": list(_build.NVCC_FLAGS),
          "libraries": [
              {"kernel": k.name, "source": k.source,
               "library": os.path.relpath(path, ROOT), "nvcc_seconds": seconds,
               "ptxas": [line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line]}
              for k, (path, seconds, log) in zip(KERNELS, built)]})


def phase_kernels(seed: int, reps: int) -> dict:
    """Each kernel against its plain version, shape by shape; returns the
    results by kernel name."""
    results = {k.name: [check_kernel_shape(k, shape, seed + i, reps)
                        for i, shape in enumerate(k.shapes)]
               for k in KERNELS}
    emit({"phase": "kernels", "tolerance": TOLERANCE,
          "stage_ops": {k.name: {str(d): stage_ops(k, d) for d in (4, 5)}
                        for k in KERNELS},
          "shapes": results})
    return results


def _tool_rows(argv) -> list[dict]:
    """The IoU tool's rows as a user runs it, in process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = benchmark_iou.main(argv)
    if rc != 0:
        raise AssertionError(f"the IoU tool printed {out.getvalue()!r}")
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


def phase_iou_tool() -> int:
    """The IoU tool as a user runs it, in process, for both box widths, then
    with every backend it has at a modest N; returns the aligned kernel's
    launches over the runs."""
    sph2pob_iou_aligned.launches = 0
    runs = []
    for d in (4, 5):
        rows = _tool_rows([
            "--size", str(TOOL_SHAPE[0]), "--box-version", str(d),
            "--iters", str(IOU_TOOL_ITERS), "--kernel"])
        if [r["backend"] for r in rows] != ["fused_plain", "kernel_fused"]:
            raise AssertionError(f"the IoU tool printed {rows}")
        if not rows[1]["max_abs_diff"] <= TOLERANCE:
            raise AssertionError(
                f"the IoU tool: kernel_fused differs from fused_plain by "
                f"{rows[1]['max_abs_diff']} at D={d}")
        runs.append(rows)
    backend_runs = []
    for d in (4, 5):
        rows = _tool_rows([
            "--size", str(TOOL_BACKENDS_SIZE), "--box-version", str(d),
            "--iters", "3", "--kernel", "--backends", *TOOL_BACKENDS])
        names = [r["backend"] for r in rows]
        if names != ["fused_plain", "kernel_fused", *TOOL_BACKENDS]:
            raise AssertionError(f"the IoU tool's rows: {names}")
        by_name = {r["backend"]: r for r in rows}
        for r in rows:
            if not all(math.isfinite(r[k]) for k in (
                    "time_s", "mean_err", "median_err", "max_err",
                    "pearson_r")):
                raise AssertionError(f"the IoU tool's row {r}")
        # (the unfused sph2pob_efficient backend is not held to the fused
        # pipeline at 1e-4: at D=5 the two forms differ by up to 3.3e-4 on
        # these pairs, in the JAX package as in this one)
        if by_name["unbiased"]["max_err"] != 0.0 \
                or not by_name["kernel_fused"]["max_abs_diff"] <= TOLERANCE \
                or not by_name["sph2pob_efficient"]["pearson_r"] > 0.99:
            raise AssertionError(f"the IoU tool's errors at D={d}: {rows}")
        backend_runs.append(rows)
    launches = sph2pob_iou_aligned.launches
    if launches < 2 * IOU_TOOL_ITERS + 2 * 4:
        raise AssertionError(
            f"{launches} launches of the aligned kernel over four runs of "
            f"{IOU_TOOL_ITERS} and 3 iterations: the tool did not go through "
            "it")
    emit({"phase": "iou_tool", "kernel_launches": launches, "rows": runs,
          "backend_rows": backend_runs})
    return launches


def check_records(records, det) -> None:
    lo, hi = (t.tolist() for t in det.det_cfg.bbox_coder.clip_bounds())
    if not isinstance(records, list) or not records:
        raise AssertionError("a request came back without a detection")
    for rec in records:
        if set(rec) != {"class_name", "bbox", "score"}:
            raise AssertionError(f"malformed record {rec}")
        box = rec["bbox"]
        if len(box) != det.box_version or not all(map(math.isfinite, box)):
            raise AssertionError(f"bad box {box}")
        if any(v < a - 1e-4 or v > b + 1e-4 for v, a, b in zip(box, lo, hi)):
            raise AssertionError(f"box {box} outside the coder's clamps")
        if not 0.0 <= rec["score"] <= 1.0:
            raise AssertionError(f"bad score {rec['score']}")


def assert_full_width(det) -> None:
    cfg = det.cfg
    got = (cfg["model"]["backbone"]["depth"], det.num_classes,
           det.box_version, tuple(cfg["img_size"]), cfg["bf16"],
           det.det_cfg.nms_backend, det.det_cfg.nms_pre)
    want = (50, 47, 5, (512, 1024), True, "sph2pob_efficient", 1000)
    if got != want:
        raise AssertionError(f"not the full-width rotated config: {got}")
    if next(det.model.parameters()).device.type != "cuda" \
            or det.model.dtype != torch.bfloat16:
        raise AssertionError("the detector does not run in bf16 on the card")


@contextlib.contextmanager
def running_server(det):
    """The HTTP server of ``det`` on a free local port, answered by one
    inference worker that has made one call already (as the server's main()
    does before it listens, so that no request pays for that thread's
    set-up); yields its base URL, stops every thread it started."""
    classes = [f"class_{i}" for i in range(det.num_classes)]
    handler = make_handler(det, classes, 0.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/ping", timeout=60) as r:
            if r.status != 200 or json.load(r) != {"status": "ok"}:
                raise AssertionError("/ping failed")
        h, w = det.cfg["img_size"]
        handler.worker.submit(inference_detector, det,
                              np.zeros((h, w, 3), np.uint8)).result()
        yield base
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        handler.worker.shutdown()
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")


def post_image(base: str, image: np.ndarray) -> tuple[float, list]:
    """One ``/predict`` of an ``np.save``d image: (host ms, records)."""
    buf = io.BytesIO()
    np.save(buf, image)
    req = urllib.request.Request(
        base + "/predict", data=buf.getvalue(), method="POST",
        headers={"Content-Type": "application/x-npy"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status, body = r.status, r.read()
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"/predict answered {status}: {body!r}")
    return ms, json.loads(body)


def phase_serve(seed: int, reps: int):
    """Returns (the kernel's launches over the served requests, the
    detector, the images, the kernel's check on the NMS input of the last
    request)."""
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    det = init_detector(CONFIG, seed=seed)
    det.model.load_state_dict(seeded_state_dict(det.model, seed))
    det.model.to(det.device)
    rng = np.random.default_rng(seed)
    h, w = det.cfg["img_size"]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for _ in range(N_REQUESTS)]
    before = calibrate_head(det, images[0])
    init_seconds = time.perf_counter() - t0
    assert_full_width(det)

    classes = [f"class_{i}" for i in range(det.num_classes)]
    with running_server(det) as base:
        sph2pob_iou_pairwise.launches = 0
        request_ms, answers = zip(*(post_image(base, im) for im in images))
        launches = sph2pob_iou_pairwise.launches
    if launches < len(images):
        raise AssertionError(
            f"{launches} kernel launches over {len(images)} requests: the "
            "serving path did not go through the kernel")
    for records in answers:
        check_records(records, det)
    # the same images with the plain version in the kernel's place
    # (one image a call, as the server ran them: a batch of another size
    # takes other convolution code, and bf16 logits then differ); the
    # kernel's input in the last call, which is the last request's, is kept
    nms_inputs = []
    nms_module.sph2pob_iou_pairwise = _recording(
        sph2pob_iou_pairwise, nms_inputs, keep_last=True)
    try:
        with_kernel = [inference_detector(det, im) for im in images]
    finally:
        nms_module.sph2pob_iou_pairwise = sph2pob_iou_pairwise
    torch.cuda.synchronize()
    # the kernel on the candidates the last request gave it
    nms_boxes = nms_inputs[-1][1]
    on_nms_input = {"input": "serve: NMS candidates of the last request",
                    **check_kernel(KERNELS[0], nms_boxes, nms_boxes, reps,
                                   identical=False)}
    launched = sph2pob_iou_pairwise.launches
    nms_module.sph2pob_iou_pairwise = sph2pob_iou_pairwise_plain
    try:
        with_plain = [inference_detector(det, im) for im in images]
    finally:
        nms_module.sph2pob_iou_pairwise = sph2pob_iou_pairwise
    if sph2pob_iou_pairwise.launches != launched:
        raise AssertionError("the plain run launched the kernel")
    n_det = 0
    for i, (a_img, b_img) in enumerate(zip(with_kernel, with_plain)):
        for c, (a, b) in enumerate(zip(a_img, b_img)):
            if a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(
                    f"image {i} class {c}: kernel and plain version keep "
                    f"different boxes ({a.shape} vs {b.shape})")
            n_det += len(a)
        served = sorted((r["class_name"], round(r["score"], 6))
                        for r in answers[i])
        direct = sorted((classes[c], round(float(row[-1]), 6))
                        for c, arr in enumerate(a_img) for row in arr)
        if served != direct:
            raise AssertionError(f"image {i}: the server's records differ "
                                 "from inference_detector's")
    emit({"phase": "serve", "config": os.path.relpath(CONFIG, ROOT),
          "requests": len(images), "kernel_launches": launches,
          "detections": [len(a) for a in answers],
          "detections_equal_with_plain_version": n_det,
          "init_seconds": init_seconds, "head_std_before_calibration": before,
          "first_request_ms": request_ms[0],
          "steady_request_ms": statistics.median(request_ms[1:]),
          "request_ms": list(request_ms),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "kernel_on_nms_input": on_nms_input})
    return launches, det, images, on_nms_input


@torch.no_grad()
def phase_breakdown(det, image: np.ndarray, reps: int) -> None:
    """Where a steady request's time goes: the network alone and the whole
    predict call by CUDA events, the whole ``inference_detector`` call by the
    host's clock, and one profiled call's device time by kernel name."""
    batch = torch.from_numpy(image[None])
    on_card = maybe_normalize_images(batch.to(det.device))
    network_ms = median_ms(lambda: det.model(on_card), reps)
    predict_ms = median_ms(lambda: det.predict(batch), reps)
    host_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        inference_detector(det, image)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    fresh_ms = []

    def in_new_thread():
        t0 = time.perf_counter()
        inference_detector(det, image)
        fresh_ms.append((time.perf_counter() - t0) * 1e3)

    for _ in range(3):  # what a thread per request would cost
        t = threading.Thread(target=in_new_thread)
        t.start()
        t.join()
    out = {"phase": "breakdown", "network_ms": network_ms,
           "predict_ms": predict_ms,
           "inference_detector_host_ms": statistics.median(host_ms),
           "inference_detector_in_a_new_thread_ms": statistics.median(fresh_ms)}

    prof = profiled(lambda: inference_detector(det, image))
    out["profiled_wall_ms"] = prof["wall_ms"]
    out["profiled_device_ms"] = prof["device_ms"]
    out["device_idle_share"] = prof["device_idle_share"]
    out["device_kernel_launches"] = prof["kernel_launches"]
    out["top_device_ms"] = prof["top_device_ms"][:8]
    out["sph2pob_iou_kernel_ms_in_request"] = prof["ms_by_kernel"].get(
        "sph2pob_iou_pairwise")
    emit(out)


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def assert_full_width_training(cfg, model, det_cfg, optimizer, device) -> None:
    """Nothing of the shipped rotated config was narrowed."""
    got = (cfg["model"]["backbone"]["depth"],
           cfg["model"]["backbone"]["frozen_stages"],
           cfg["model"]["num_classes"], cfg["model"]["box_version"],
           tuple(cfg["img_size"]), cfg["bf16"],
           cfg["data"]["samples_per_gpu"], cfg["data"]["max_gt"],
           optimizer.grad_clip, det_cfg.assign_backend,
           tuple(det_cfg.flat_anchors().shape))
    want = (50, 1, 47, 5, (512, 1024), True, TRAIN_BATCH, 64, 35.0,
            "sph2pob_efficient", (ASSIGN_SHAPE[1], 5))
    if got != want:
        raise AssertionError(f"not the full-width rotated config: {got}")
    if next(model.parameters()).device.type != "cuda" \
            or model.dtype != torch.bfloat16:
        raise AssertionError("the detector does not train in bf16 on the card")
    frozen = set(optimizer.frozen_names)
    if "backbone.layer1_2.conv3.weight" not in frozen \
            or "backbone.layer2_0.conv1.weight" in frozen \
            or len(model.backbone.stage_blocks) != 4 \
            or sum(model.backbone.stage_blocks) != 16:
        raise AssertionError("frozen stage 1 of a ResNet-50 expected, got "
                             f"{sorted(frozen)[:4]}...")


def train_step_parts(model, det_cfg, optimizer, loader, host_batch,
                     device, reps: int = 5) -> dict:
    """Where a training step's wall time goes: each part run on its own
    between two synchronisations and timed by the host's clock (so a part's
    time holds its launches' dispatch and the device's work, whichever is
    longer), median of ``reps``. ``losses`` is ``retina_loss`` less the
    assignment it contains; ``loss_bbox`` is the regression loss alone, timed
    inside it. The parts add up to more than a step, whose dispatch runs
    ahead of the device."""
    anchors = det_cfg.flat_anchors(device)
    parts = {k: [] for k in ("loader_batch", "h2d", "forward", "assignment",
                             "losses", "loss_bbox", "backward", "optimizer")}
    loss_bbox = det_cfg.loss_bbox

    def timed_loss_bbox(*args, **kwargs):
        return timed("loss_bbox", lambda: loss_bbox(*args, **kwargs))

    timed_cfg = dataclasses.replace(det_cfg, loss_bbox=timed_loss_bbox)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        timed("loader_batch", lambda: list(loader.epoch(0)))
        batch = timed("h2d", lambda: to_device(
            {k: v for k, v in host_batch.items() if k != "img_id"}, device))
        gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
        optimizer.zero_grad()
        cls, reg = timed("forward", lambda: model(batch["images"]))
        timed("assignment", lambda: single_stage.anchor_targets(
            det_cfg, anchors, *gt))
        losses = timed("losses", lambda: single_stage.retina_loss(
            timed_cfg, cls, reg, anchors, *gt))
        parts["losses"][-1] -= parts["assignment"][-1]
        total = losses["loss_cls"] + losses["loss_bbox"]
        timed("backward", total.backward)
        timed("optimizer", optimizer.step)
    return {k: statistics.median(v) for k, v in parts.items()}


def _recording(fn, calls: list, keep_last: bool = False):
    """``fn`` that also appends each call's shapes to ``calls`` — with
    ``keep_last``, only the last call's, with copies of its inputs."""
    def wrapper(boxes1, boxes2):
        shapes = [list(boxes1.shape), list(boxes2.shape)]
        if keep_last:
            calls[:] = [(shapes, boxes1.clone(), boxes2.clone())]
        else:
            calls.append(shapes)
        return fn(boxes1, boxes2)
    return wrapper


def timed_steps(step, batch, n: int) -> dict:
    """``n`` steps on one batch, each between CUDA events and on the host's
    clock; the first apart, the median of the rest."""
    event_ms, host_ms, losses = [], [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(batch)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        losses.append({k: float(v) for k, v in metrics.items()})
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"a loss is not finite: {losses}")
    return {"first_step_ms": {"events": event_ms[0], "host": host_ms[0]},
            "steady_step_ms": {"events": statistics.median(event_ms[1:]),
                               "host": statistics.median(host_ms[1:])},
            "losses": losses}


def drive_trainer(config: str, steps: int, batch: int, seed: int) -> dict:
    """``train.main`` as a user starts it, one epoch of ``steps`` steps,
    logging every step. The pairwise kernel's launch counter is set to 0
    just before and read just after; its calls are recorded (shapes, and
    the inputs of the last call of each shape). Returns the config, what
    ``build_training`` built, the per-step log records, the kernel's
    launches and calls, and the trainer's wall time."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    built, calls, last_inputs = {}, [], {}
    build_training = train_cli.build_training

    def capturing(cfg, *args, **kwargs):
        built["cfg"] = cfg
        built["parts"] = build_training(cfg, *args, **kwargs)
        return built["parts"]

    def recording(boxes1, boxes2):
        last_inputs[(boxes1.shape[0], boxes2.shape[0])] = (boxes1.clone(),
                                                           boxes2.clone())
        return _recording(sph2pob_iou_pairwise, calls)(boxes1, boxes2)

    train_cli.build_training = capturing
    single_stage.sph2pob_iou_pairwise = recording
    faster_rcnn.sph2pob_iou_pairwise = recording
    said = io.StringIO()
    try:
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build")) as work:
            sph2pob_iou_pairwise.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(said):
                rc = train_cli.main([
                    config, "--synthetic", "--seed", str(seed),
                    "--max-epochs", "1", "--work-dir", work, "--cfg-options",
                    f"data.n_synthetic={steps * batch}",
                    "log_config.interval=1"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = sph2pob_iou_pairwise.launches
            with open(os.path.join(work, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
    finally:
        train_cli.build_training = build_training
        single_stage.sph2pob_iou_pairwise = sph2pob_iou_pairwise
        faster_rcnn.sph2pob_iou_pairwise = sph2pob_iou_pairwise
    if rc != 0 or "training done" not in said.getvalue():
        raise AssertionError(f"the trainer said {said.getvalue()!r}")
    logged = [r for r in records if r["prefix"] == "train"]
    if [r["step"] for r in logged] != list(range(1, steps + 1)):
        raise AssertionError(f"expected {steps} logged steps: {records}")
    for r in logged:
        if not all(math.isfinite(r[k]) for k in ("loss", "loss_cls",
                                                 "loss_bbox")):
            raise AssertionError(f"a loss is not finite: {r}")
    return {"cfg": built["cfg"], "parts": built["parts"], "steps": logged,
            "launches": launches, "calls": calls,
            "last_inputs": last_inputs, "seconds": seconds}


def phase_train(seed: int, reps: int) -> tuple[int, dict]:
    """Returns the pairwise kernel's launches over the trainer's steps and
    its check on the assignment input of the fixed batch."""
    device = resolve_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) the trainer as a user starts it: one epoch of 6 steps
    run = drive_trainer(CONFIG, TRAIN_STEPS, TRAIN_BATCH, seed)
    model, det_cfg, _, optimizer, _ = run["parts"]
    assert_full_width_training(run["cfg"], model, det_cfg, optimizer, device)
    launches, calls, steps = run["launches"], run["calls"], run["steps"]
    if launches != TRAIN_STEPS or optimizer.count != TRAIN_STEPS:
        raise AssertionError(
            f"{launches} launches of the pairwise kernel over "
            f"{optimizer.count} steps: one a step expected")
    want_call = [list(ASSIGN_SHAPE[::2]), list(ASSIGN_SHAPE[1:])]
    if any(c != want_call for c in calls) or len(calls) != TRAIN_STEPS:
        raise AssertionError(f"the kernel was called at {calls}")
    cli_seconds = run["seconds"]
    cli_step_ms = [(b["time"] - a["time"]) * 1e3
                   for a, b in zip(steps, steps[1:])]
    out = {"phase": "train", "config": os.path.relpath(CONFIG, ROOT),
           "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
           "kernel_launches": launches, "kernel_call_shapes": calls[0],
           "trainable_tensors": len(optimizer.params),
           "frozen_tensors": len(optimizer.frozen_names),
           "trainer_seconds": cli_seconds,
           "trainer_losses": [r["loss"] for r in steps],
           "trainer_lr_first_last": [optimizer.schedule(0),
                                     optimizer.schedule(TRAIN_STEPS - 1)],
           "trainer_step_ms_logged_every_step": statistics.median(cli_step_ms)}
    del model, optimizer, run

    # (b) a fixed batch repeated, warm-up off for this check only, so that
    # six steps at the base rate can show the loss falling
    cfg = apply_overrides(load_config(CONFIG), [
        "lr_config.warmup_iters=0", f"data.n_synthetic={TRAIN_BATCH}"])
    model, det_cfg, loader, optimizer, step = train_cli.build_training(
        cfg, device, seed)
    (host_batch,) = list(loader.epoch(0))
    batch = to_device({k: v for k, v in host_batch.items() if k != "img_id"},
                      device)
    fixed = timed_steps(step, batch, TRAIN_STEPS)
    losses = fixed["losses"]
    if not losses[-1]["loss"] < losses[0]["loss"]:
        raise AssertionError(
            f"the loss did not fall on a fixed batch: {losses}")
    # steps enqueued back to back, one synchronisation at the end
    n_free = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_free):
        metrics = step(batch)
    torch.cuda.synchronize()
    free_ms = (time.perf_counter() - t0) * 1e3 / n_free
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError("the loss stopped being finite")
    peak = torch.cuda.max_memory_allocated()

    # the plain version in the kernel's place: the same targets
    anchors = det_cfg.flat_anchors(device)
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
    before = sph2pob_iou_pairwise.launches
    with_kernel = single_stage.anchor_targets(det_cfg, anchors, *gt)
    single_stage.sph2pob_iou_pairwise = sph2pob_iou_pairwise_plain
    try:
        with_plain = single_stage.anchor_targets(det_cfg, anchors, *gt)
    finally:
        single_stage.sph2pob_iou_pairwise = sph2pob_iou_pairwise
    if sph2pob_iou_pairwise.launches != before + 1:
        raise AssertionError("the plain run launched the kernel")
    for name, a, b in zip(with_kernel._fields, with_kernel, with_plain):
        if not torch.equal(a, b):
            raise AssertionError(
                f"anchor targets differ in {name} between the kernel and "
                "its plain version")
    del with_plain
    # the kernel on the input the assignment gives it: the batch's padded
    # gts (B * max_gt rows) against the anchors
    on_assign_input = {
        "input": "train: gt_boxes of the fixed batch x the anchors",
        **check_kernel(KERNELS[0],
                       batch["gt_boxes"].reshape(-1, ASSIGN_SHAPE[2])
                       .contiguous(), anchors.contiguous(), reps,
                       identical=False)}

    prof = profiled(lambda: step(batch))
    parts = train_step_parts(model, det_cfg, optimizer, loader, host_batch,
                             device)
    out.update({
        "fixed_batch_lr": optimizer.last_lr,
        "fixed_batch_note": "warm-up off (lr_config.warmup_iters=0) for this "
                            "check only; the trainer above ran the config's "
                            "own warm-up",
        "fixed_batch_losses": losses,
        "first_step_ms": fixed["first_step_ms"],
        "steady_step_ms": fixed["steady_step_ms"],
        "step_ms_enqueued_back_to_back": free_ms,
        "peak_memory_bytes": peak,
        "num_pos": int(with_kernel.num_pos),
        "targets_equal_with_plain_version": True,
        "profiled_step_wall_ms": prof["wall_ms"],
        "profiled_step_device_ms": prof["device_ms"],
        "device_busy_share": None if prof["device_idle_share"] is None
        else 1.0 - prof["device_idle_share"],
        "device_kernel_launches": prof["kernel_launches"],
        "top_device_ms": prof["top_device_ms"],
        "sph2pob_iou_kernel_ms_in_step": prof["ms_by_kernel"].get(
            "sph2pob_iou_pairwise"),
        "step_parts_ms_each_synchronised": parts,
        "kernel_on_assignment_input": on_assign_input,
    })
    emit(out)
    return launches, on_assign_input


def assert_full_width_iou_training(cfg, model, det_cfg, optimizer) -> None:
    """Nothing of the shipped Sphere-bench config was narrowed: R18 from
    scratch, 12 classes, 4-dof boxes, 256x512, bf16, batch 8, max_gt 24,
    decoded-box Sph2Pob-CIoU, assignment by the fused pairwise kernel."""
    loss = det_cfg.loss_bbox
    got = (cfg["model"]["backbone"]["depth"],
           cfg["model"]["backbone"]["frozen_stages"],
           cfg["model"]["num_classes"], cfg["model"].get("box_version", 4),
           tuple(cfg["img_size"]), cfg["bf16"],
           cfg["data"]["samples_per_gpu"], cfg["data"]["max_gt"],
           optimizer.grad_clip, det_cfg.assign_backend,
           det_cfg.reg_decoded_bbox, getattr(loss, "func", None),
           getattr(loss, "keywords", None),
           tuple(det_cfg.flat_anchors().shape))
    want = (18, 0, 12, 4, (256, 512), True, IOU_TRAIN_BATCH,
            IOU_ASSIGN_SHAPE[0] // IOU_TRAIN_BATCH, 35.0, "sph2pob_efficient",
            True, sph2pob_iou_loss, {"mode": "ciou", "loss_weight": 1.0},
            (IOU_ASSIGN_SHAPE[1], 4))
    if got != want:
        raise AssertionError(f"not the full-width Sphere-bench config: {got}")
    if next(model.parameters()).device.type != "cuda" \
            or model.dtype != torch.bfloat16 \
            or model.backbone.stage_blocks != (2, 2, 2, 2):
        raise AssertionError("the detector is not an R18 training in bf16 "
                             "on the card")
    frozen = set(optimizer.frozen_names)
    if "backbone.conv1.weight" not in frozen \
            or "backbone.layer1_0.conv1.weight" in frozen:
        raise AssertionError("frozen_stages=0 freezes the stem alone, got "
                             f"{sorted(frozen)[:4]}...")


def phase_train_iou_loss(seed: int, reps: int) -> tuple[int, dict]:
    """The Sphere-bench config (decoded-box Sph2Pob-CIoU) through the
    trainer. Returns the pairwise kernel's launches over the trainer's steps
    and its check on the last step's assignment input."""
    device = resolve_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) the trainer as a user starts it: one epoch, one launch a step
    run = drive_trainer(IOU_CONFIG, IOU_TRAIN_STEPS, IOU_TRAIN_BATCH, seed)
    trainer_peak = torch.cuda.max_memory_allocated()
    model, det_cfg, loader, optimizer, step = run["parts"]
    assert_full_width_iou_training(run["cfg"], model, det_cfg, optimizer)
    launches, calls, steps = run["launches"], run["calls"], run["steps"]
    if launches != IOU_TRAIN_STEPS or optimizer.count != IOU_TRAIN_STEPS:
        raise AssertionError(
            f"{launches} launches of the pairwise kernel over "
            f"{optimizer.count} steps: one a step expected")
    want_call = [list(IOU_ASSIGN_SHAPE[::2]), list(IOU_ASSIGN_SHAPE[1:])]
    if any(c != want_call for c in calls) or len(calls) != IOU_TRAIN_STEPS:
        raise AssertionError(f"the kernel was called at {calls}")
    for r in steps:
        if not r["loss_bbox"] > 0.0:
            raise AssertionError(f"loss_bbox is not positive: {r}")
    gt_flat, anchors = run["last_inputs"][IOU_ASSIGN_SHAPE[:2]]
    on_input = {"input": "train_iou_loss: gt_boxes of the trainer's last "
                         "step x the anchors",
                **check_kernel(KERNELS[0], gt_flat, anchors, reps,
                               identical=False)}
    cli_step_ms = [(b["time"] - a["time"]) * 1e3
                   for a, b in zip(steps, steps[1:])]
    cli_seconds = run["seconds"]
    del model, optimizer, step, loader, run

    # (b) where a step's time goes, on one batch repeated
    cfg = apply_overrides(load_config(IOU_CONFIG),
                          [f"data.n_synthetic={IOU_TRAIN_BATCH}"])
    model, det_cfg, loader, optimizer, step = train_cli.build_training(
        cfg, device, seed)
    (host_batch,) = list(loader.epoch(0))
    batch = to_device({k: v for k, v in host_batch.items() if k != "img_id"},
                      device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ciou = timed_steps(step, batch, 6)
    step_peak = torch.cuda.max_memory_allocated()
    prof = profiled(lambda: step(batch))
    parts = train_step_parts(model, det_cfg, optimizer, loader, host_batch,
                             device)

    # (c) the same config with the base config's L1 loss on encoded deltas,
    # in turns with the CIoU step on the same batch
    l1_cfg = apply_overrides(load_config(IOU_CONFIG), [
        "model.loss_bbox={'type':'SphL1Loss','loss_weight':1.0}",
        "model.reg_decoded_bbox=False",
        f"data.n_synthetic={IOU_TRAIN_BATCH}"])
    _, _, _, _, l1_step = train_cli.build_training(l1_cfg, device, seed)
    l1 = timed_steps(l1_step, batch, 6)
    l1_prof = profiled(lambda: l1_step(batch))
    ciou_again = timed_steps(step, batch, 6)
    del model, optimizer, step, l1_step

    emit({"phase": "train_iou_loss",
          "config": os.path.relpath(IOU_CONFIG, ROOT),
          "steps": IOU_TRAIN_STEPS, "batch": IOU_TRAIN_BATCH,
          "loss_bbox": "Sph2PobIoULoss(mode='ciou') on decoded boxes",
          "kernel_launches": launches, "kernel_call_shapes": calls[0],
          "trainer_seconds": cli_seconds,
          "trainer_loss_bbox": [r["loss_bbox"] for r in steps],
          "trainer_loss_cls": [r["loss_cls"] for r in steps],
          "trainer_pos_dropped": [r.get("metric_pos_dropped")
                                  for r in steps],
          "trainer_step_ms_logged_every_step": statistics.median(cli_step_ms),
          "trainer_peak_memory_bytes": trainer_peak,
          "ciou_step": ciou, "l1_step": l1, "ciou_step_again": ciou_again,
          "added_step_ms_over_l1": {
              k: statistics.mean([ciou["steady_step_ms"][k],
                                  ciou_again["steady_step_ms"][k]])
              - l1["steady_step_ms"][k] for k in ("events", "host")},
          "step_peak_memory_bytes": step_peak,
          "profiled_step_wall_ms": prof["wall_ms"],
          "profiled_step_device_ms": prof["device_ms"],
          "device_busy_share": None if prof["device_idle_share"] is None
          else 1.0 - prof["device_idle_share"],
          "device_kernel_launches": prof["kernel_launches"],
          "l1_device_kernel_launches": l1_prof["kernel_launches"],
          "l1_profiled_step_device_ms": l1_prof["device_ms"],
          "top_device_ms": prof["top_device_ms"],
          "sph2pob_iou_kernel_ms_in_step": prof["ms_by_kernel"].get(
              "sph2pob_iou_pairwise"),
          "step_parts_ms_each_synchronised": parts,
          "kernel_on_assignment_input": on_input})
    return launches, on_input


def phase_serve_unbiased(seed: int) -> None:
    """One request (after one in the worker's thread, as the server's main()
    makes) to the server of the PANDORA RetinaNet config, whose NMS takes
    the unbiased oracle through ``sph_overlaps``: plain PyTorch on the card,
    a (k, k, 40, 8, 3) fp32 product for k NMS candidates."""
    det = init_detector(UNBIASED_CONFIG, seed=seed)
    det.model.load_state_dict(seeded_state_dict(det.model, seed))
    det.model.to(det.device)
    rng = np.random.default_rng(seed + 1)
    h, w = det.cfg["img_size"]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for _ in range(N_UNBIASED_REQUESTS)]
    calibrate_head(det, images[0])
    got = (det.cfg["model"]["backbone"]["depth"], det.num_classes,
           det.box_version, tuple(det.cfg["img_size"]),
           det.det_cfg.nms_backend, det.det_cfg.nms_pre)
    if got != (50, 47, 4, UNBIASED_IMG_SIZE, "unbiased_iou", 1000):
        raise AssertionError(f"not the full-width PANDORA config: {got}")

    nms_calls = []
    sph_overlaps = nms_module.sph_overlaps

    def recording(boxes1, boxes2, backend):
        nms_calls.append((list(boxes1.shape), backend))
        return sph_overlaps(boxes1, boxes2, backend)

    nms_module.sph_overlaps = recording
    try:
        with running_server(det) as base:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = sph2pob_iou_pairwise.launches
            del nms_calls[:]
            request_ms, answers = zip(*(post_image(base, im)
                                        for im in images))
            peak = torch.cuda.max_memory_allocated()
    finally:
        nms_module.sph_overlaps = sph_overlaps
    for records in answers:
        check_records(records, det)
    if [b for _, b in nms_calls] != ["unbiased_iou"] * len(images) \
            or sph2pob_iou_pairwise.launches != before:
        raise AssertionError(f"the NMS did not take the unbiased oracle: "
                             f"{nms_calls}")
    emit({"phase": "serve_unbiased",
          "config": os.path.relpath(UNBIASED_CONFIG, ROOT),
          "requests": len(images), "nms_iou_calls": nms_calls,
          "detections": [len(a) for a in answers],
          "request_ms": list(request_ms), "peak_memory_bytes": peak})
    del det



# --------------------------------------------------------------------------- #
# the SSD, Kent and FCOS families
# --------------------------------------------------------------------------- #
def fixed_batch(config: str, batch: int, seed: int, device):
    """``build_training`` of a config on one synthetic batch of ``batch``
    images (warm-up as the config has it): (model, detector config,
    optimiser, train step, the batch on the card)."""
    cfg = apply_overrides(load_config(config), [f"data.n_synthetic={batch}"])
    model, det_cfg, loader, optimizer, step = train_cli.build_training(
        cfg, device, seed)
    (host_batch,) = list(loader.epoch(0))
    on_card = to_device({k: v for k, v in host_batch.items()
                         if k != "img_id"}, device)
    return model, det_cfg, optimizer, step, on_card


def step_report(step, batch, n: int) -> dict:
    """``n`` timed steps on one batch, their peak memory, one profiled step
    (device time, busy share, launches, the largest kernels)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = timed_steps(step, batch, n)
    peak = torch.cuda.max_memory_allocated()
    prof = profiled(lambda: step(batch))
    return {**timed, "peak_memory_bytes": peak,
            "profiled_step_wall_ms": prof["wall_ms"],
            "profiled_step_device_ms": prof["device_ms"],
            "device_busy_share": None if prof["device_idle_share"] is None
            else 1.0 - prof["device_idle_share"],
            "device_kernel_launches": prof["kernel_launches"],
            "top_device_ms": prof["top_device_ms"][:6],
            "sph2pob_iou_kernel_ms_in_step": prof["ms_by_kernel"].get(
                "sph2pob_iou_pairwise")}


def _loss_of(det_cfg):
    loss = det_cfg.loss_bbox
    return getattr(loss, "func", loss), getattr(loss, "keywords", None)


def _on_card_in_bf16(model, what: str) -> None:
    if next(model.parameters()).device.type != "cuda" \
            or model.dtype != torch.bfloat16:
        raise AssertionError(f"the {what} does not run in bf16 on the card")


def assert_full_width_ssd(cfg, model, det_cfg) -> None:
    """The shipped SSD-VGG16 indoor360 config, nothing narrowed."""
    got = (cfg["model"]["type"], det_cfg.num_classes, det_cfg.box_version,
           det_cfg.img_size, cfg["bf16"], cfg["data"]["samples_per_gpu"],
           cfg["data"]["max_gt"], cfg["optimizer"]["lr"],
           det_cfg.assign_backend, det_cfg.reg_decoded_bbox,
           det_cfg.loss_pos_topk, *_loss_of(det_cfg),
           tuple(det_cfg.flat_anchors().shape))
    want = ("SphSSD", 37, 4, (512, 1024), True, SSD_TRAIN_BATCH,
            SSD_ASSIGN_SHAPE[0] // SSD_TRAIN_BATCH, 2e-3, "sph2pob_efficient",
            True, 512, sph2pob_iou_loss, {"mode": "iou", "loss_weight": 1.0},
            (SSD_ASSIGN_SHAPE[1], 4))
    if got != want:
        raise AssertionError(f"not the full-width SSD config: {got}")
    _on_card_in_bf16(model, "SSD")
    if sum(1 for n, _ in model.backbone.named_children()
           if n.startswith("conv")) != 15:
        raise AssertionError("not VGG16's 13 convs + conv6 + conv7")


def assert_full_width_kent(cfg, model, det_cfg, box_version: int,
                           loss) -> None:
    """A shipped Kent config: R50, 37 classes, 512x1024, bf16, batch 1,
    max_gt 64, assignment by the Kent KLD surrogate."""
    got = (cfg["model"].get("type", "SphRetinaNet"),
           cfg["model"]["backbone"]["depth"], det_cfg.num_classes,
           det_cfg.box_version, det_cfg.img_size, cfg["bf16"],
           cfg["data"]["samples_per_gpu"], cfg["data"]["max_gt"],
           det_cfg.assign_backend, _loss_of(det_cfg)[0],
           tuple(det_cfg.flat_anchors().shape))
    want = ("SphRetinaNet", 50, 37, box_version, (512, 1024), True, 1,
            KENT_ASSIGN_PAIRS[0], "kent", loss,
            (KENT_ASSIGN_PAIRS[1], box_version))
    if got != want:
        raise AssertionError(f"not the full-width Kent config: {got}")
    _on_card_in_bf16(model, "Kent RetinaNet")


def assert_full_width_fcos(cfg, model, det_cfg) -> None:
    """The shipped FCOS-R50 indoor360 config, nothing narrowed."""
    got = (cfg["model"]["type"], cfg["model"]["backbone"]["depth"],
           det_cfg.num_classes, det_cfg.box_version, det_cfg.img_size,
           cfg["bf16"], cfg["data"]["samples_per_gpu"], cfg["data"]["max_gt"],
           *_loss_of(det_cfg),
           sum(p.shape[0] for p in det_cfg.level_points()[0]))
    want = ("SphFCOS", 50, 37, 4, (512, 1024), True, FCOS_TRAIN_BATCH, 64,
            sph2pob_iou_loss, {"mode": "iou", "loss_weight": 1.0}, 10912)
    if got != want:
        raise AssertionError(f"not the full-width FCOS config: {got}")
    _on_card_in_bf16(model, "FCOS")


def trainer_summary(run) -> dict:
    steps = run["steps"]
    return {"kernel_launches": run["launches"],
            "trainer_seconds": run["seconds"],
            "trainer_losses": [{k: r[k] for k in r
                                if k.startswith(("loss", "metric"))}
                               for r in steps],
            "trainer_step_ms_logged_every_step": statistics.median(
                (b["time"] - a["time"]) * 1e3
                for a, b in zip(steps, steps[1:])) if len(steps) > 1
            else None}


def phase_train_ssd(seed: int, reps: int) -> tuple[int, dict]:
    """The SSD-VGG16 config through the trainer: one launch of the pairwise
    kernel a step at (256, 49056) D=4 (its third real input), bitwise equal
    to the plain version on the last step's input; then a fixed batch.
    Returns the kernel's launches over the trainer's steps and its check."""
    device = resolve_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drive_trainer(SSD_CONFIG, SSD_TRAIN_STEPS, SSD_TRAIN_BATCH, seed)
    trainer_peak = torch.cuda.max_memory_allocated()
    model, det_cfg, _, optimizer, _ = run["parts"]
    assert_full_width_ssd(run["cfg"], model, det_cfg)
    launches, calls = run["launches"], run["calls"]
    if launches != SSD_TRAIN_STEPS or optimizer.count != SSD_TRAIN_STEPS:
        raise AssertionError(
            f"{launches} launches of the pairwise kernel over "
            f"{optimizer.count} steps: one a step expected")
    want_call = [list(SSD_ASSIGN_SHAPE[::2]), list(SSD_ASSIGN_SHAPE[1:])]
    if any(c != want_call for c in calls) or len(calls) != SSD_TRAIN_STEPS:
        raise AssertionError(f"the kernel was called at {calls}")
    gt_flat, anchors = run["last_inputs"][SSD_ASSIGN_SHAPE[:2]]
    on_input = {"input": "train_ssd: gt_boxes of the trainer's last step x "
                         "the SSD anchors",
                **check_kernel(KERNELS[0], gt_flat, anchors, reps,
                               identical=False)}
    if not on_input["bitwise_equal"]:
        raise AssertionError(f"the kernel differs from its plain version "
                             f"by {on_input['max_abs_err']} at the SSD input")
    summary = trainer_summary(run)
    del model, optimizer, run

    _, _, _, step, batch = fixed_batch(SSD_CONFIG, SSD_TRAIN_BATCH, seed,
                                       device)
    report = step_report(step, batch, 5)
    emit({"phase": "train_ssd", "config": os.path.relpath(SSD_CONFIG, ROOT),
          "steps": SSD_TRAIN_STEPS, "batch": SSD_TRAIN_BATCH,
          "kernel_call_shapes": calls[0], **summary,
          "trainer_peak_memory_bytes": trainer_peak,
          "fixed_batch": report, "kernel_on_assignment_input": on_input})
    return launches, on_input


def phase_train_kent(seed: int) -> None:
    """The Kent-KLD config (Kent assignment at (64, 98208), KentLoss on
    decoded boxes) through the trainer, the Kent assignment alone, and two
    trainer steps of the 5-dof Kent config with delta-L1. Every loss of
    every step finite; no kernel runs on these paths."""
    device = resolve_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drive_trainer(KENT_KLD_CONFIG, KENT_TRAIN_STEPS, 1, seed)
    trainer_peak = torch.cuda.max_memory_allocated()
    model, det_cfg, _, _, _ = run["parts"]
    assert_full_width_kent(run["cfg"], model, det_cfg, 4, sph_kent_loss)
    kld = trainer_summary(run)
    del model, run

    # the Kent assignment of one batch alone: its padded gts x the anchors
    model, det_cfg, _, step, batch = fixed_batch(KENT_KLD_CONFIG, 1, seed,
                                                 device)
    anchors = det_cfg.flat_anchors(device)

    @torch.no_grad()
    def assign():
        return single_stage._batch_pairwise_iou(batch["gt_boxes"], anchors,
                                                det_cfg.assign_backend)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    overlaps = assign()
    torch.cuda.synchronize()
    assign_peak = torch.cuda.max_memory_allocated() - base
    if tuple(overlaps.shape) != (1, *KENT_ASSIGN_PAIRS) \
            or not bool(torch.isfinite(overlaps).all()):
        raise AssertionError(f"Kent overlaps {tuple(overlaps.shape)}, "
                             "finite: " + str(bool(torch.isfinite(
                                 overlaps).all())))
    max_overlap = float(overlaps.max())
    del overlaps
    assign_ms = median_ms(assign, 5, warmup=1)
    assign_prof = profiled(assign)
    report = step_report(step, batch, 4)
    del model, step, batch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drive_trainer(KENT_L1_CONFIG, KENT_L1_STEPS, 1, seed)
    l1_peak = torch.cuda.max_memory_allocated()
    model, det_cfg, _, _, _ = run["parts"]
    assert_full_width_kent(run["cfg"], model, det_cfg, 5, sph_l1_loss)
    l1 = trainer_summary(run)
    del model, run
    if kld["kernel_launches"] or l1["kernel_launches"]:
        raise AssertionError("the Kent paths launched the pairwise kernel")
    emit({"phase": "train_kent",
          "config": os.path.relpath(KENT_KLD_CONFIG, ROOT),
          "steps": KENT_TRAIN_STEPS, "batch": 1, **kld,
          "trainer_peak_memory_bytes": trainer_peak,
          "kent_assignment": {
              "pairs": list(KENT_ASSIGN_PAIRS), "events_ms": assign_ms,
              "device_ms": assign_prof["device_ms"],
              "device_kernel_launches": assign_prof["kernel_launches"],
              "peak_memory_bytes_above_inputs": assign_peak,
              "max_overlap": max_overlap},
          "fixed_batch": report,
          "l1_config": os.path.relpath(KENT_L1_CONFIG, ROOT),
          "l1_steps": KENT_L1_STEPS, "l1_trainer": l1,
          "l1_trainer_peak_memory_bytes": l1_peak})


def phase_train_fcos(seed: int) -> None:
    """The FCOS-R50 config through the trainer (targets for 10,912 points x
    64 gts a image, the Sph2Pob IoU loss on all 43,648 rows a step), then a
    fixed batch. No kernel runs on this path."""
    device = resolve_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drive_trainer(FCOS_CONFIG, FCOS_TRAIN_STEPS, FCOS_TRAIN_BATCH, seed)
    trainer_peak = torch.cuda.max_memory_allocated()
    model, det_cfg, _, _, _ = run["parts"]
    assert_full_width_fcos(run["cfg"], model, det_cfg)
    summary = trainer_summary(run)
    if summary["kernel_launches"]:
        raise AssertionError("the FCOS path launched the pairwise kernel")
    if not all(math.isfinite(r["loss_centerness"]) and r["loss_centerness"] > 0
               for r in run["steps"]):
        raise AssertionError(f"loss_centerness: {summary['trainer_losses']}")
    del model, run
    _, _, _, step, batch = fixed_batch(FCOS_CONFIG, FCOS_TRAIN_BATCH, seed,
                                       device)
    report = step_report(step, batch, 5)
    emit({"phase": "train_fcos", "config": os.path.relpath(FCOS_CONFIG, ROOT),
          "steps": FCOS_TRAIN_STEPS, "batch": FCOS_TRAIN_BATCH, **summary,
          "loss_centerness": [m["loss_centerness"]
                              for m in report["losses"]],
          "trainer_peak_memory_bytes": trainer_peak, "fixed_batch": report})


@torch.no_grad()
def calibrate_family_head(det, image: np.ndarray, cls_std=2.0,
                          reg_std=0.3) -> dict:
    """``calibrate_head`` for every family: rescale the output convs so
    that, on a seeded image, the logits have standard deviation ``cls_std``
    and the regression outputs ``reg_std`` (FCOS: its log-distances, about
    log 32 pixels), so that scores pass ``score_thr`` and boxes stay off the
    coder's clamps."""
    head = det.model.bbox_head
    if hasattr(head, "retina_cls"):
        return calibrate_head(det, image, cls_std, reg_std)
    x = maybe_normalize_images(torch.from_numpy(image[None]).to(det.device))
    outs = det.model(x)
    if hasattr(head, "conv_cls"):  # FCOS: one conv each, shared by levels
        cls = torch.cat([c.flatten() for c in outs[0]])
        log_dist = torch.cat([r.log().flatten() for r in outs[1]])
        head.conv_cls.weight.mul_(cls_std / float(cls.std()))
        head.conv_reg.weight.mul_(reg_std / float(log_dist.std()))
        head.conv_reg.bias.fill_(math.log(32.0))
        return {"cls_std": float(cls.std()),
                "log_distance_std": float(log_dist.std())}
    before = {"cls_std": [], "reg_std": []}  # SSD: one conv each a level
    for i, (cls, reg) in enumerate(zip(*outs)):
        before["cls_std"].append(float(cls.std()))
        before["reg_std"].append(float(reg.std()))
        getattr(head, f"cls_conv_{i}").weight.mul_(cls_std / float(cls.std()))
        getattr(head, f"reg_conv_{i}").weight.mul_(reg_std / float(reg.std()))
    return before


def assert_full_width_served(det, family: str) -> None:
    got = (det.cfg["model"].get("type", "SphRetinaNet"), det.num_classes,
           tuple(det.cfg["img_size"]), det.cfg["bf16"])
    if got != (family, 37, (512, 1024), True):
        raise AssertionError(f"not the full-width {family} config: {got}")
    _on_card_in_bf16(det.model, family)


def phase_serve_families(seed: int) -> None:
    """One ``inference_detector`` request each (after one warm-up call) to
    the FCOS-R50, SSD-VGG16 and Kent-KLD configs at full width, seeded
    weights: a non-empty result of finite boxes and scores in [0, 1]."""
    rows = []
    for config, family in ((FCOS_CONFIG, "SphFCOS"), (SSD_CONFIG, "SphSSD"),
                           (KENT_KLD_CONFIG, "SphRetinaNet")):
        det = init_detector(config, seed=seed)
        det.model.load_state_dict(seeded_state_dict(det.model, seed))
        det.model.to(det.device)
        assert_full_width_served(det, family)
        rng = np.random.default_rng(seed + 2)
        image = rng.integers(0, 256, (512, 1024, 3), dtype=np.uint8)
        before = calibrate_family_head(det, image)
        inference_detector(det, image)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = inference_detector(det, image)
        ms = (time.perf_counter() - t0) * 1e3
        n_det = sum(len(a) for a in result)
        if len(result) != det.num_classes or n_det == 0:
            raise AssertionError(f"{family}: {n_det} detections")
        for a in result:
            if a.shape[1:] != (det.box_version + 1,) \
                    or not np.isfinite(a).all() \
                    or not ((a[:, -1] >= 0) & (a[:, -1] <= 1)).all():
                raise AssertionError(f"{family}: malformed result {a[:2]}")
        rows.append({"config": os.path.relpath(config, ROOT),
                     "family": family, "nms_backend": det.det_cfg.nms_backend,
                     "detections": n_det, "request_ms": ms,
            "head_std_before_calibration": before,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "head_std_before_calibration": before})
        del det
    emit({"phase": "serve_families", "requests": rows})


# --------------------------------------------------------------------------- #
# Faster R-CNN
# --------------------------------------------------------------------------- #
def assert_full_width_frcnn(cfg, model, det_cfg, leaf: tuple, rpn_shape,
                            roi_shape, sampler: str, loss_mode: str) -> None:
    """A shipped Faster R-CNN config, nothing narrowed: ``leaf`` is its
    (depth, classes, img_size); the batch, max_gt and anchors are those of
    the kernel's two inputs; 512 proposals and 256 rois a image; the
    decoded-box Sph2Pob IoU loss of ``loss_mode``; bf16 on the card."""
    max_gt = roi_shape[0]
    got = (cfg["model"]["type"], cfg["model"]["backbone"]["depth"],
           det_cfg.num_classes, det_cfg.img_size, det_cfg.box_version,
           cfg["bf16"], cfg["data"]["samples_per_gpu"], cfg["data"]["max_gt"],
           det_cfg.num_proposals, det_cfg.num_rois, det_cfg.sampler_type,
           det_cfg.assign_backend, det_cfg.reg_decoded_bbox,
           *_loss_of(det_cfg), tuple(det_cfg.flat_anchors().shape))
    want = ("SphFasterRCNN", *leaf, 4, True, rpn_shape[0] // max_gt, max_gt,
            roi_shape[1] - max_gt, 256, sampler, "sph2pob_efficient", True,
            sph2pob_iou_loss, {"mode": loss_mode, "loss_weight": 1.0},
            (rpn_shape[1], 4))
    if got != want:
        raise AssertionError(f"not the full-width Faster R-CNN config: {got}")
    _on_card_in_bf16(model, "Faster R-CNN")


def frcnn_calls_ok(run, steps: int, rpn_shape, roi_shape, batch: int) -> None:
    """One launch a step at the RPN's input, then one a image at the RoI
    sampler's."""
    step = [[list(rpn_shape[::2]), list(rpn_shape[1:])]] + \
        [[list(roi_shape[::2]), list(roi_shape[1:])]] * batch
    if run["calls"] != step * steps or run["launches"] != len(step) * steps:
        raise AssertionError(
            f"{run['launches']} launches of the pairwise kernel over {steps} "
            f"steps, at {run['calls'][:len(step) + 1]}...: {len(step)} a step "
            "expected")


def greedy_sweeps(iou: torch.Tensor, valid: torch.Tensor, thr: float) -> int:
    """How many sweeps ``boxes/nms.py:_greedy_suppress`` makes on these
    inputs (each ends in one host-device synchronisation): the same
    iteration, counted."""
    dom = (iou > thr).triu(diagonal=1)
    keep, sweeps = valid, 0
    for _ in range(iou.shape[0] + 1):
        new = valid & ~(dom & keep[:, None]).any(dim=0)
        sweeps += 1
        if torch.equal(new, keep):
            break
        keep = new
    return sweeps


def rpn_nms_sweeps(step, batch) -> list:
    """The sweep count of each RPN NMS of one step (one a image)."""
    inputs = []
    suppress = nms_module._greedy_suppress

    def recording(iou, valid, thr):
        inputs.append((iou.clone(), valid.clone(), thr))
        return suppress(iou, valid, thr)

    nms_module._greedy_suppress = recording
    try:
        step(batch)
    finally:
        nms_module._greedy_suppress = suppress
    return [{"k": iou.shape[0], "valid": int(valid.sum()),
             "sweeps": greedy_sweeps(iou, valid, thr)}
            for iou, valid, thr in inputs]


@torch.no_grad()
def calibrate_frcnn_head(det, image: np.ndarray, cls_std=2.0,
                         reg_std=0.3, n_pass=60) -> dict:
    """``calibrate_head`` for Faster R-CNN: rescale the RPN's two output
    convs and the RoI head's two output layers so that, on a seeded image,
    the logits have standard deviation ``cls_std`` and the deltas
    ``reg_std`` (random weights otherwise put every box on the coder's
    clamps and every class score below ``score_thr``)."""
    model, cfg = det.model, det.det_cfg
    x = maybe_normalize_images(torch.from_numpy(image[None]).to(det.device))
    (rpn_cls, rpn_reg), feats = model(x)
    before = {"rpn_cls_std": float(torch.cat(rpn_cls, 1).std()),
              "rpn_reg_std": float(torch.cat(rpn_reg, 1).std())}
    model.rpn_head.rpn_cls.weight.mul_(cls_std / before["rpn_cls_std"])
    model.rpn_head.rpn_reg.weight.mul_(reg_std / before["rpn_reg_std"])
    (rpn_cls, rpn_reg), feats = model(x)
    props, _, _ = faster_rcnn.rpn_proposals(cfg, rpn_cls, rpn_reg)
    logits, deltas = model.roi(
        faster_rcnn.roi_features(cfg, feats, props).flatten(0, 1))
    before.update(cls_std=float(logits.std()), reg_std=float(deltas.std()))
    model.bbox_head.fc_cls.weight.mul_(cls_std / before["cls_std"])
    model.bbox_head.fc_reg.weight.mul_(reg_std / before["reg_std"])
    # the background logit raised until about ``n_pass`` (proposal, class)
    # pairs pass score_thr: fewer than max_per_img, so that the boxes
    # soft-NMS decays (and hard NMS removes) reach the output
    logits = logits * (cls_std / before["cls_std"])
    lo, hi = 0.0, 20.0
    for _ in range(30):
        mid = (lo + hi) / 2
        shifted = logits.clone()
        shifted[:, -1] += mid
        n = int((torch.softmax(shifted, -1)[:, :-1] > cfg.score_thr).sum())
        lo, hi = (mid, hi) if n > n_pass else (lo, mid)
    model.bbox_head.fc_cls.bias[-1] += hi
    before["background_bias"] = hi
    return before


def serve_soft_nms(seed: int) -> dict:
    """One ``inference_detector`` request (after one warm-up call) to the
    soft-NMS leaf at full width, seeded weights, the heads calibrated
    (``calibrate_frcnn_head``): records come back, and the soft-NMS call's
    own output shows scores decayed below the raw ones and boxes kept that
    hard NMS, on the same inputs, removes."""
    det = init_detector(FRCNN_SOFT_CONFIG, seed=seed)
    det.model.load_state_dict(seeded_state_dict(det.model, seed))
    det.model.to(det.device)
    assert_full_width_served(det, "SphFasterRCNN")
    if (det.det_cfg.nms_type, det.det_cfg.soft_method) != ("soft_nms",
                                                           "linear"):
        raise AssertionError(f"not the soft-NMS config: {det.det_cfg}")
    h, w = det.cfg["img_size"]
    image = np.random.default_rng(seed + 3).integers(0, 256, (h, w, 3),
                                                     dtype=np.uint8)
    before = calibrate_frcnn_head(det, image)
    inference_detector(det, image)
    calls = []
    soft = faster_rcnn.sph_batched_soft_nms

    def recording(boxes, scores, idxs, **kw):
        res = soft(boxes, scores, idxs, **kw)
        calls.append((boxes, scores, idxs, kw, res))
        return res

    faster_rcnn.sph_batched_soft_nms = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = inference_detector(det, image)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        faster_rcnn.sph_batched_soft_nms = soft
    n_det = sum(len(a) for a in result)
    if len(result) != det.num_classes or n_det == 0 or len(calls) != 1:
        raise AssertionError(f"soft-NMS request: {n_det} detections, "
                             f"{len(calls)} soft-NMS calls")
    for a in result:
        if a.shape[1:] != (det.box_version + 1,) or not np.isfinite(a).all() \
                or not ((a[:, -1] >= det.det_cfg.soft_min_score)
                        & (a[:, -1] <= 1)).all():
            raise AssertionError(f"soft-NMS: malformed result {a[:2]}")
    boxes, scores, idxs, kw, res = calls[0]
    valid = res.valid
    raw = scores[res.inds]
    decayed = int(((res.scores < raw - 1e-6) & valid).sum())
    kw = {k: v for k, v in kw.items()
          if k not in ("sigma", "min_score", "method")}
    hard = nms_module.sph_batched_nms(boxes, scores, idxs, **kw)
    kept_by_hard = set(hard.inds[hard.valid].tolist())
    kept_only_by_soft = [i for i in res.inds[valid].tolist()
                         if i not in kept_by_hard]
    if decayed == 0 or not kept_only_by_soft:
        raise AssertionError(
            f"soft-NMS decayed {decayed} scores and kept "
            f"{len(kept_only_by_soft)} boxes that hard NMS removes")
    return {"config": os.path.relpath(FRCNN_SOFT_CONFIG, ROOT),
            "detections": n_det, "request_ms": ms,
            "head_std_before_calibration": before,
            "scores_decayed": decayed,
            "kept_that_hard_nms_removes": len(kept_only_by_soft),
            "hard_nms_detections": int(hard.valid.sum()),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def phase_train_frcnn(seed: int, reps: int) -> tuple[int, list]:
    """The Faster R-CNN family: the indoor360 R50 leaf through the trainer
    (one launch of the pairwise kernel a step at (256, 130944), K1's largest
    real input, and four at (64, 576), the RoI sampler's), the kernel
    bitwise equal to its plain version on the last step's inputs at both
    shapes, then a fixed batch; one step of the OHEM leaf, two of the R18
    Sphere-bench leaf (the CIoU RoI loss), one request to the soft-NMS leaf.
    The OHEM leaf's step is also timed on a fixed batch.
    Returns the kernel's launches over the trainers' steps and its checks."""
    device = resolve_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = drive_trainer(FRCNN_CONFIG, FRCNN_TRAIN_STEPS, FRCNN_TRAIN_BATCH,
                        seed)
    trainer_peak = torch.cuda.max_memory_allocated()
    model, det_cfg, _, optimizer, _ = run["parts"]
    assert_full_width_frcnn(run["cfg"], model, det_cfg, FRCNN_LEAF,
                            FRCNN_RPN_SHAPE, FRCNN_ROI_SHAPE, "random", "iou")
    frcnn_calls_ok(run, FRCNN_TRAIN_STEPS, FRCNN_RPN_SHAPE, FRCNN_ROI_SHAPE,
                   FRCNN_TRAIN_BATCH)
    launches = run["launches"]
    checks = []
    for shape, what in ((FRCNN_RPN_SHAPE, "RPN gt_boxes x the anchors"),
                        (FRCNN_ROI_SHAPE, "the last image's gts x its "
                                          "proposals + gts (RoI sampler)")):
        b1, b2 = run["last_inputs"][shape[:2]]
        checks.append({"input": f"train_frcnn: {what}, the trainer's last "
                                "step",
                       **check_kernel(KERNELS[0], b1, b2, reps,
                                      identical=False)})
        if not checks[-1]["bitwise_equal"]:
            raise AssertionError(
                f"the kernel differs from its plain version by "
                f"{checks[-1]['max_abs_err']} at the {what} input")
    summary = trainer_summary(run)
    del model, optimizer, run

    _, _, _, step, batch = fixed_batch(FRCNN_CONFIG, FRCNN_TRAIN_BATCH, seed,
                                       device)
    report = step_report(step, batch, FRCNN_FIXED_STEPS)
    sweeps = rpn_nms_sweeps(step, batch)
    del step, batch

    ohem = drive_trainer(FRCNN_OHEM_CONFIG, 1, FRCNN_TRAIN_BATCH, seed)
    model, det_cfg, _, _, _ = ohem["parts"]
    assert_full_width_frcnn(ohem["cfg"], model, det_cfg, FRCNN_LEAF,
                            FRCNN_RPN_SHAPE, FRCNN_ROI_SHAPE, "ohem", "iou")
    frcnn_calls_ok(ohem, 1, FRCNN_RPN_SHAPE, FRCNN_ROI_SHAPE,
                   FRCNN_TRAIN_BATCH)
    launches += ohem["launches"]
    del model, ohem["parts"]
    # the OHEM step's time beside the random sampler's, on the same batch
    _, _, _, step, batch = fixed_batch(FRCNN_OHEM_CONFIG, FRCNN_TRAIN_BATCH,
                                       seed, device)
    ohem_timed = timed_steps(step, batch, 3)
    del step, batch

    r18_batch = FRCNN_R18_RPN_SHAPE[0] // FRCNN_R18_ROI_SHAPE[0]
    torch.cuda.reset_peak_memory_stats()
    r18 = drive_trainer(FRCNN_R18_CONFIG, FRCNN_R18_STEPS, r18_batch, seed)
    model, det_cfg, _, _, _ = r18["parts"]
    assert_full_width_frcnn(r18["cfg"], model, det_cfg, FRCNN_R18_LEAF,
                            FRCNN_R18_RPN_SHAPE, FRCNN_R18_ROI_SHAPE,
                            "random", "ciou")
    frcnn_calls_ok(r18, FRCNN_R18_STEPS, FRCNN_R18_RPN_SHAPE,
                   FRCNN_R18_ROI_SHAPE, r18_batch)
    launches += r18["launches"]
    r18_peak = torch.cuda.max_memory_allocated()
    del model, r18["parts"]

    torch.cuda.reset_peak_memory_stats()
    served = serve_soft_nms(seed)
    emit({"phase": "train_frcnn",
          "config": os.path.relpath(FRCNN_CONFIG, ROOT),
          "steps": FRCNN_TRAIN_STEPS, "batch": FRCNN_TRAIN_BATCH, **summary,
          "trainer_peak_memory_bytes": trainer_peak,
          "fixed_batch": report, "rpn_nms_sweeps_of_one_step": sweeps,
          "kernel_on_frcnn_inputs": checks,
          "ohem": {"config": os.path.relpath(FRCNN_OHEM_CONFIG, ROOT),
                   "steps": 1, **trainer_summary(ohem),
                   "fixed_batch_step_ms": {
                       k: ohem_timed[k] for k in ("first_step_ms",
                                                  "steady_step_ms")}},
          "r18": {"config": os.path.relpath(FRCNN_R18_CONFIG, ROOT),
                  "steps": FRCNN_R18_STEPS, "batch": r18_batch,
                  **trainer_summary(r18), "peak_memory_bytes": r18_peak},
          "soft_nms_request": served})
    return launches, checks


# --------------------------------------------------------------------------- #
# the training workflow on an annotation file
# --------------------------------------------------------------------------- #
COCO_TRAIN_IMAGES = 16   # 4 steps an epoch at batch 4
COCO_VAL_IMAGES = 8      # 2 batches, one K1 launch an image in the NMS
COCO_CROWD = 3           # iscrowd annotations in val
COCO_EPOCHS = 2
COCO_RESUME_EPOCHS = 3
COCO_CLASS_COLORS = np.array([[255, 64, 64], [64, 255, 64], [64, 64, 255],
                              [255, 255, 64], [255, 64, 255], [64, 255, 255]],
                             np.uint8)


def write_coco(root: str, split: str, n_images: int, num_classes: int,
               img_size, seed: int, n_crowd: int = 0) -> tuple[str, str]:
    """A COCO-style set of noise panoramas, each with 1-6 RBFoV boxes painted
    at their equirectangular footprint, over ``num_classes`` categories;
    the first ``n_crowd`` images get one ``iscrowd`` annotation each.
    Returns (annotation file, image directory)."""
    from PIL import Image

    h, w = img_size
    img_dir = os.path.join(root, split)
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for img_id in range(1, n_images + 1):
        canvas = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        n = int(rng.integers(1, 7))
        for k in range(n + (img_id <= n_crowd)):
            label = int(rng.integers(0, num_classes))
            box = [float(rng.uniform(40.0, 320.0)),
                   float(rng.uniform(50.0, 130.0)),
                   float(rng.uniform(20.0, 60.0)),
                   float(rng.uniform(20.0, 55.0)),
                   float(rng.uniform(-30.0, 30.0))]
            t, p, fx, fy = box[:4]
            canvas[max(int((p - fy / 2) / 180 * h), 0):
                   min(int((p + fy / 2) / 180 * h), h),
                   max(int((t - fx / 2) / 360 * w), 0):
                   min(int((t + fx / 2) / 360 * w), w)] = \
                COCO_CLASS_COLORS[label % len(COCO_CLASS_COLORS)]
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id,
                "category_id": label + 1, "bbox": box, "area": fx * fy,
                "iscrowd": int(k == n)})
        name = f"{split}_{img_id:04d}.png"
        Image.fromarray(canvas).save(os.path.join(img_dir, name))
        images.append({"id": img_id, "file_name": name, "width": w,
                       "height": h})
    ann_file = os.path.join(root, f"{split}.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": i + 1, "name": f"class_{i}"}
                                  for i in range(num_classes)]}, f)
    return ann_file, img_dir + "/"


class _Workflow:
    """Instruments the workflow's entry points without changing them: the
    pairwise kernel's calls at the assignment and in the NMS, each
    evaluation (time, split into predict and matching; peak memory apart
    from training's), each checkpoint save and restore (time; the restored
    state held bitwise against the file), and the first step after a
    restore."""

    def __init__(self):
        self.calls = {"assign": [], "nms": []}
        self.nms_last = []
        self.evals, self.saves, self.restores = [], [], []
        self.train_peaks = []
        self.first_step_ms = None
        self._timing_first = False

    @contextlib.contextmanager
    def installed(self):
        wf = self
        real = {"ckpt": train_cli.Checkpointer,
                "t_eval": train_cli.evaluate_dataset,
                "c_eval": test_cli.evaluate_dataset,
                "build": train_cli.build_training}

        def recording(site):
            def call(boxes1, boxes2):
                wf.calls[site].append([list(boxes1.shape),
                                       list(boxes2.shape)])
                if site == "nms":
                    wf.nms_last[:] = [boxes1.clone()]
                return sph2pob_iou_pairwise(boxes1, boxes2)
            return call

        class Timed(real["ckpt"]):
            def save(self, model, optimizer, epoch, metric=None,
                     generator=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = super().save(model, optimizer, epoch, metric,
                                    generator)
                wf.saves.append({"epoch": epoch, "ms": (time.perf_counter()
                                                        - t0) * 1e3,
                                 "bytes": os.path.getsize(path)})
                return path

            def restore(self, model, optimizer, path=None, generator=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step = super().restore(model, optimizer, path, generator)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                saved = runner.read_checkpoint(self.latest_path())
                own = model.state_dict()
                bufs = optimizer.state_dict()["momentum_buffers"]
                wf.restores.append({
                    "ms": ms, "step": step,
                    "model_bitwise": all(torch.equal(own[k].cpu(), v)
                                         for k, v in saved["model"].items()),
                    "momentum_bitwise": all(
                        torch.equal(bufs[k].cpu(), v) for k, v in
                        saved["optimizer"]["momentum_buffers"].items()),
                    "generator_bitwise": torch.equal(
                        generator.get_state(), saved["generator"])})
                wf._timing_first = True
                return step

        def timed_eval(model, cfg, loader, **kw):
            predict, predict_ms = kw.pop("predict"), []

            def timed_predict(images):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = predict(images)
                torch.cuda.synchronize()
                predict_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            match_ms, n_dets = [], []

            def timed_match(det_results, *a, **k):
                n_dets.append(sum(len(boxes) for boxes, _, _ in det_results))
                t0 = time.perf_counter()
                out = eval_spherical_map(det_results, *a, **k)
                match_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            wf.train_peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            evaluator.eval_spherical_map = timed_match
            t0 = time.perf_counter()
            try:
                metrics = real["t_eval"](model, cfg, loader,
                                         predict=timed_predict, **kw)
            finally:
                evaluator.eval_spherical_map = eval_spherical_map
            seconds = time.perf_counter() - t0
            n = metrics["n_images"]
            wf.evals.append({
                "seconds": seconds, "images": n, "detections": sum(n_dets),
                "ms_an_image": seconds * 1e3 / n,
                "predict_ms_an_image": sum(predict_ms) / n,
                "matching_ms_an_image": sum(match_ms) / n,
                "peak_memory_bytes": torch.cuda.max_memory_allocated()})
            torch.cuda.reset_peak_memory_stats()
            return metrics

        def building(*a, **kw):
            parts = real["build"](*a, **kw)
            step = parts[4]

            def timed_step(batch):
                if not wf._timing_first:
                    return step(batch)
                wf._timing_first = False
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(batch)
                torch.cuda.synchronize()
                wf.first_step_ms = (time.perf_counter() - t0) * 1e3
                return out

            timed_step.generator = step.generator
            return (*parts[:4], timed_step)

        train_cli.Checkpointer = Timed
        train_cli.evaluate_dataset = test_cli.evaluate_dataset = timed_eval
        train_cli.build_training = building
        single_stage.sph2pob_iou_pairwise = recording("assign")
        nms_module.sph2pob_iou_pairwise = recording("nms")
        try:
            yield self
        finally:
            train_cli.Checkpointer = real["ckpt"]
            train_cli.evaluate_dataset = real["t_eval"]
            test_cli.evaluate_dataset = real["c_eval"]
            train_cli.build_training = real["build"]
            single_stage.sph2pob_iou_pairwise = sph2pob_iou_pairwise
            nms_module.sph2pob_iou_pairwise = sph2pob_iou_pairwise


def _said(fn) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn()
    if rc != 0:
        raise AssertionError(f"exit code {rc}: {out.getvalue()!r}")
    return out.getvalue()


def val_detections(ann_file: str, seed: int, jitter: float):
    """The val ground truth as detections (seeded continuous scores),
    jittered by ``jitter`` degrees, and the annotations with their crowd
    regions."""
    ds = SphCocoDataset(ann_file=ann_file, box_version=5)
    rng = np.random.default_rng(seed)
    dets, anns = [], []
    for i in range(len(ds)):
        item = ds[i]
        boxes = item["boxes"] + rng.normal(
            0.0, jitter, item["boxes"].shape).astype(np.float32)
        dets.append((boxes, rng.uniform(0.1, 1.0, len(boxes))
                     .astype(np.float32), item["labels"]))
        anns.append({k: item[k] for k in ("boxes", "labels", "ignore_boxes",
                                          "ignore_labels")})
    return dets, anns


def phase_train_coco(seed: int, reps: int) -> tuple[int, dict]:
    """The training workflow on an annotation file at full width: the
    trainer on a COCO-style set with evaluation and checkpoints every epoch,
    ``--auto-resume`` for one more epoch, the test CLI on the checkpoint,
    spherical mAP on the card against the CPU, and publishing. Returns the
    pairwise kernel's launches over the workflow and its check on the last
    val image's NMS input."""
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    device = resolve_device()
    cfg = load_config(CONFIG)
    classes = cfg["model"]["num_classes"]
    img_size = tuple(cfg["img_size"])
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        train_ann, train_dir = write_coco(tmp, "train", COCO_TRAIN_IMAGES,
                                          classes, img_size, seed)
        val_ann, val_dir = write_coco(tmp, "val", COCO_VAL_IMAGES, classes,
                                      img_size, seed + 1, COCO_CROWD)
        write_seconds = time.perf_counter() - t0
        work, ckpts = os.path.join(tmp, "work"), os.path.join(tmp, "work",
                                                              "ckpts")
        data = [f"data.train.ann_file={train_ann}",
                f"data.train.img_prefix={train_dir}",
                *(f"data.{s}.{k}={v}" for s in ("val", "test")
                  for k, v in (("ann_file", val_ann),
                               ("img_prefix", val_dir)))]
        argv = [CONFIG, "--seed", str(seed), "--work-dir", work,
                "--cfg-options", "evaluation.interval=1",
                "checkpoint_config.interval=1", "log_config.interval=1",
                *data]
        wf = _Workflow()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with wf.installed():
            sph2pob_iou_pairwise.launches = 0
            t0 = time.perf_counter()
            said = _said(lambda: train_cli.main(
                argv[:1] + ["--max-epochs", str(COCO_EPOCHS)] + argv[1:]))
            first_seconds = time.perf_counter() - t0
            wf.train_peaks.append(torch.cuda.max_memory_allocated())
            first_launches = sph2pob_iou_pairwise.launches
            first_calls = {k: list(v) for k, v in wf.calls.items()}
            with open(os.path.join(work, "metrics.jsonl")) as f:
                first = [json.loads(line) for line in f]
            on_disk = sorted(os.listdir(ckpts))

            said_resume = _said(lambda: train_cli.main(
                argv[:1] + ["--max-epochs", str(COCO_RESUME_EPOCHS),
                            "--auto-resume"] + argv[1:]))
            with open(os.path.join(work, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            resumed_launches = sph2pob_iou_pairwise.launches - first_launches

            out_json = os.path.join(tmp, "res.json")
            said_test = _said(lambda: test_cli.main([
                CONFIG, ckpts, "--out", out_json, "--cfg-options", *data]))
            with open(out_json) as f:
                tested = json.load(f)
            nms_input = wf.nms_last[0]

            said_pub = _said(lambda: publish_cli.main(
                [CONFIG, ckpts, os.path.join(tmp, "pub", "model.npz")]))
            (npz,) = os.listdir(os.path.join(tmp, "pub"))
            npz = os.path.join(tmp, "pub", npz)
            image = SphCocoDataset(ann_file=val_ann, img_prefix=val_dir)[0][
                "img_path"]
            from_npz = inference_detector(init_detector(CONFIG, npz), image)
            from_ckpt = inference_detector(init_detector(CONFIG, ckpts),
                                           image)
            launches = sph2pob_iou_pairwise.launches

        # (a) the first run: 8 logged steps, an evaluation and a checkpoint
        # every epoch, one kernel launch a step and one a val image
        steps = COCO_TRAIN_IMAGES // TRAIN_BATCH
        logged = [r["step"] for r in first if r["prefix"] == "train"]
        vals = [r for r in records if r["prefix"] == "val"]
        if logged != list(range(1, COCO_EPOCHS * steps + 1)):
            raise AssertionError(f"logged steps {logged}")
        for r in vals:
            if not all(math.isfinite(r[k]) for k in ("mAP", "AP50", "AP75")):
                raise AssertionError(f"a val record is not finite: {r}")
        if len([r for r in first if r["prefix"] == "val"]) != COCO_EPOCHS:
            raise AssertionError(f"val records {first}")
        if on_disk != sorted(["best", "latest.txt"] + [
                f"epoch_{e}" for e in range(1, COCO_EPOCHS + 1)]):
            raise AssertionError(f"checkpoint directory holds {on_disk}")
        want_assign = [list(ASSIGN_SHAPE[::2]), list(ASSIGN_SHAPE[1:])]
        if first_calls["assign"] != [want_assign] * (COCO_EPOCHS * steps):
            raise AssertionError(f"assignment calls {first_calls['assign']}")
        nms_calls = first_calls["nms"]
        if len(nms_calls) != COCO_EPOCHS * COCO_VAL_IMAGES or any(
                a != b or a[0] > 1000 or a[1] != 5 for a, b in nms_calls):
            raise AssertionError(f"NMS calls {nms_calls}")
        if first_launches != COCO_EPOCHS * (steps + COCO_VAL_IMAGES):
            raise AssertionError(
                f"{first_launches} kernel launches in the first run")

        # (b) the resume: from step 8, steps 9-12, no replay, the state
        # restored bitwise
        if "resumed from step 8" not in said_resume:
            raise AssertionError(f"the resumed trainer said {said_resume!r}")
        later = [r["step"] for r in records[len(first):]
                 if r["prefix"] == "train"]
        if later != list(range(COCO_EPOCHS * steps + 1,
                               COCO_RESUME_EPOCHS * steps + 1)):
            raise AssertionError(f"the resumed run logged steps {later}")
        (restored,) = wf.restores
        if not (restored["step"] == COCO_EPOCHS * steps
                and restored["model_bitwise"] and restored["momentum_bitwise"]
                and restored["generator_bitwise"]):
            raise AssertionError(f"the restore: {restored}")
        if resumed_launches != steps + COCO_VAL_IMAGES:
            raise AssertionError(
                f"{resumed_launches} kernel launches after the resume")

        # (c) the test CLI reproduces the last in-training evaluation
        if f"loaded checkpoint at step {COCO_RESUME_EPOCHS * steps}" \
                not in said_test:
            raise AssertionError(f"the test CLI said {said_test!r}")
        ap50_diff = abs(tested["AP50"] - vals[-1]["AP50"])
        if not ap50_diff <= 1e-4:
            raise AssertionError(
                f"the test CLI's AP50 {tested['AP50']} differs from the "
                f"last evaluation's {vals[-1]['AP50']} by {ap50_diff}")

        # (d) an AP that is not trivially 0: the val ground truth as
        # detections, and jittered, matched on the card and on the CPU
        on_card = {}
        for name, jitter in (("ground_truth", 0.0), ("jittered_3deg", 3.0)):
            dets, anns = val_detections(val_ann, seed, jitter)
            card = eval_spherical_map(dets, anns, classes,
                                      backend="sph2pob_efficient",
                                      device=device)
            cpu = eval_spherical_map(dets, anns, classes,
                                     backend="sph2pob_efficient",
                                     device="cpu")
            diff = max(abs(card[k] - cpu[k]) for k in ("mAP", "AP50", "AP75"))
            if not diff <= 1e-6:
                raise AssertionError(f"{name}: card {card} vs CPU {cpu}")
            on_card[name] = {k: card[k] for k in ("mAP", "AP50", "AP75")}
            on_card[name]["max_diff_to_cpu"] = diff
        if on_card["ground_truth"]["mAP"] != 1.0:
            raise AssertionError(f"the ground truth scores {on_card}")

        # (e) the published model predicts what the checkpoint predicts
        if f"published -> {npz}" not in said_pub:
            raise AssertionError(f"the publish CLI said {said_pub!r}")
        for a, b in zip(from_npz, from_ckpt):
            if a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(
                    "the published model and the checkpoint predict "
                    "differently")
        npz_bytes = os.path.getsize(npz)

    on_nms_input = {"input": "train_coco: NMS candidates of the last val "
                             "image of the test CLI",
                    **check_kernel(KERNELS[0], nms_input, nms_input, reps,
                                   identical=False)}
    emit({"phase": "train_coco", "config": os.path.relpath(CONFIG, ROOT),
          "pil_importable": pil, "dataset_write_seconds": write_seconds,
          "train_images": COCO_TRAIN_IMAGES, "val_images": COCO_VAL_IMAGES,
          "crowd_annotations": COCO_CROWD, "batch": TRAIN_BATCH,
          "first_run_seconds": first_seconds,
          "val_records": [{k: r[k] for k in ("step", "mAP", "AP50", "AP75")}
                          for r in vals],
          "test_cli": tested, "test_cli_ap50_diff": ap50_diff,
          "kernel_launches": {"first_run": first_launches,
                              "resumed_run": resumed_launches,
                              "whole_phase": launches},
          "nms_call_shapes": sorted({tuple(a) for a, _ in nms_calls}),
          "evaluations": wf.evals, "checkpoint_saves": wf.saves,
          "checkpoint_restore": restored,
          "first_step_after_resume_ms": wf.first_step_ms,
          "training_peak_memory_bytes": max(wf.train_peaks),
          "evaluation_peak_memory_bytes": max(e["peak_memory_bytes"]
                                              for e in wf.evals),
          "map_card_vs_cpu": on_card, "published_npz_bytes": npz_bytes,
          "published_equals_checkpoint": True,
          "kernel_on_val_nms_input": on_nms_input})
    return launches, on_nms_input


# --------------------------------------------------------------------------- #
# export and deployment evaluation
# --------------------------------------------------------------------------- #
EXPORT_IMAGES = 3
EXPORT_TOLERANCE = 1e-5  # the JAX package's export test: rtol = atol = 1e-5
DEPLOY_TOLERANCE = 1e-3  # its deployment test, on the metrics
DISPATCH_CALLS = 2000


def host_ms(fn, reps: int) -> list:
    """Milliseconds of each of ``reps`` calls of ``fn`` on the host's
    clock, each from a synchronised card to a synchronised card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def dispatch_overhead(seed: int) -> dict:
    """What the custom op adds to a K1 call: host microseconds a call at
    (1000, 1000) D=5 through the op, through the public wrapper (argument
    checks, then the op), through the op's CUDA kernel called as a plain
    function (allocation, stream, launch: the wrapper's body before the op)
    and through the ``ctypes`` launcher directly into a preallocated output,
    ``DISPATCH_CALLS`` calls back to back and one synchronisation, in turns
    (direct, impl, op, wrapper, wrapper, op, impl, direct)."""
    from sph_retina_tpu_torch.ops import sph2pob_iou as k1_module

    b1, b2 = (torch.from_numpy(b).cuda()
              for b in pairwise_inputs(SERVING_SHAPE, seed))
    n, m, d = SERVING_SHAPE
    out = torch.empty((n, m), dtype=torch.float32, device="cuda")
    launch = k1_module._pairwise_launcher()

    def direct():
        if launch(b1.data_ptr(), b2.data_ptr(), out.data_ptr(), n, m, d,
                  torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the direct launch failed")

    calls = {"direct": direct,
             "impl": lambda: k1_module._pairwise_cuda(b1, b2),
             "op": lambda: torch.ops.sph_retina.sph2pob_iou_pairwise(b1, b2),
             "wrapper": lambda: sph2pob_iou_pairwise(b1, b2)}
    us = {name: [] for name in calls}
    for name in ("direct", "impl", "op", "wrapper", "wrapper", "op", "impl",
                 "direct"):
        for _ in range(10):
            calls[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            calls[name]()
        torch.cuda.synchronize()
        us[name].append((time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS)
    if not torch.equal(out, calls["op"]()):
        raise AssertionError("the op and the direct launch differ")
    return {"shape": list(SERVING_SHAPE), "calls": DISPATCH_CALLS,
            "host_us_a_call": us,
            "op_over_impl_us": min(us["op"]) - min(us["impl"]),
            "op_over_direct_us": min(us["op"]) - min(us["direct"]),
            "wrapper_over_direct_us": min(us["wrapper"]) - min(us["direct"])}


def phase_export(seed: int, reps: int) -> int:
    """The rotated R50 config at full width, seeded and calibrated as in
    phase ``serve``, exported at batch 1 (``export_program``,
    ``save_program``, ``load_exported``, each timed); the artifact against
    the live predict on ``EXPORT_IMAGES`` images (labels, validity and
    indices equal, boxes and scores within ``EXPORT_TOLERANCE``), K1
    launched once an image by the artifact, one profiled call, ms an image
    beside the live predict's; then ``deployment_test.main`` on the artifact
    over the 8 val images ``write_coco`` writes, against ``evaluate_dataset``
    with the live predict (metrics within ``DEPLOY_TOLERANCE``), and the
    custom op's dispatch cost. Returns K1's launches by the artifact."""
    torch.backends.cudnn.deterministic = True
    det = init_detector(CONFIG, seed=seed)
    det.model.load_state_dict(seeded_state_dict(det.model, seed))
    det.model.to(det.device)
    rng = np.random.default_rng(seed)
    h, w = det.cfg["img_size"]
    raw = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
           for _ in range(EXPORT_IMAGES)]
    calibrate_head(det, raw[0])
    assert_full_width(det)
    # the artifact's input: float32 (1, H, W, 3), normalised
    images = [maybe_normalize_images(torch.from_numpy(r[None]).to(det.device))
              for r in raw]

    t0 = time.perf_counter()
    program = export_cli.export_program(det, batch_size=1)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = export_cli.save_program(program)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    call = export_cli.load_exported(blob)
    load_s = time.perf_counter() - t0
    nodes = [str(n.target) for n in call.program.graph.nodes]
    if nodes.count("sph_retina.sph2pob_iou_pairwise.default") != 1:
        raise AssertionError("the exported graph holds no K1 node")

    sph2pob_iou_pairwise.launches = 0
    got = [call(x) for x in images]
    torch.cuda.synchronize()
    artifact_launches = sph2pob_iou_pairwise.launches
    if artifact_launches != EXPORT_IMAGES:
        raise AssertionError(f"{artifact_launches} K1 launches over "
                             f"{EXPORT_IMAGES} images of the artifact")
    live = [det.predict(x) for x in images]
    diffs = {}
    for g, l in zip(got, live):
        for name, a, b in zip(l._fields, g, l):
            diff = float((a.double() - b.double()).abs().max())
            diffs[name] = max(diffs.get(name, 0.0), diff)
            if name in ("labels", "valid", "inds"):
                ok = torch.equal(a, b)
            else:
                ok = torch.allclose(a, b, rtol=EXPORT_TOLERANCE,
                                    atol=EXPORT_TOLERANCE)
            if not ok:
                raise AssertionError(f"the artifact's {name} differ from the "
                                     f"live predict's by {diff}")
    bitwise = all(torch.equal(a, b) for g, l in zip(got, live)
                  for a, b in zip(g, l))
    n_det = [int(l.valid.sum()) for l in live]

    prof = profiled(lambda: call(images[-1]))
    n_prof = prof["launches_by_kernel"].get("sph2pob_iou_pairwise", 0)
    k1_device_ms = prof["ms_by_kernel"]["sph2pob_iou_pairwise"] / n_prof \
        if n_prof else None
    timing = {"live": [], "artifact": []}
    for name in ("live", "artifact", "artifact", "live"):
        fn = det.predict if name == "live" else call
        timing[name] += host_ms(lambda: fn(images[-1]), reps // 2)

    # deployment evaluation over the val set of phase train_coco
    classes = det.num_classes
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        val_ann, val_dir = write_coco(tmp, "val", COCO_VAL_IMAGES, classes,
                                      (h, w), seed + 1, COCO_CROWD)
        path = os.path.join(tmp, "model.pt2")
        with open(path, "wb") as f:
            f.write(blob)
        data = [f"data.test.ann_file={val_ann}",
                f"data.test.img_prefix={val_dir}"]
        out_json = os.path.join(tmp, "res.json")
        sph2pob_iou_pairwise.launches = 0
        t0 = time.perf_counter()
        _said(lambda: deployment_cli.main([CONFIG, path, "--out", out_json,
                                           "--cfg-options", *data]))
        deploy_s = time.perf_counter() - t0
        deploy_launches = sph2pob_iou_pairwise.launches
        with open(out_json) as f:
            deployed = json.load(f)
        cfg = apply_overrides(load_config(CONFIG), data)
        cfg["data"]["samples_per_gpu"] = 1
        t0 = time.perf_counter()
        expected, raw = evaluator.evaluate_dataset(
            det.model, det.det_cfg, build_datasets(cfg, "test")[1],
            predict=det.predict, return_raw=True)
        live_s = time.perf_counter() - t0
    if deploy_launches != COCO_VAL_IMAGES:
        raise AssertionError(f"{deploy_launches} K1 launches over "
                             f"{COCO_VAL_IMAGES} val images")
    metric_diff = {k: abs(deployed[k] - v) for k, v in expected.items()
                   if isinstance(v, float) and math.isfinite(v)}
    if set(metric_diff) != set(deployed) or \
            not max(metric_diff.values()) <= DEPLOY_TOLERANCE:
        raise AssertionError(f"deployment metrics {deployed} against the "
                             f"in-framework evaluation's {expected}")
    emit({"phase": "export", "config": os.path.relpath(CONFIG, ROOT),
          "batch_size": 1, "artifact_bytes": len(blob),
          "export_seconds": export_s, "save_seconds": save_s,
          "load_seconds": load_s, "graph_nodes": len(nodes),
          "graph_dtype_checks": sum("_assert_tensor_metadata" in t
                                    for t in nodes),
          "images": EXPORT_IMAGES,
          "detections": n_det, "max_abs_diff_to_live": diffs,
          "bitwise_equal_to_live": bitwise, "tolerance": EXPORT_TOLERANCE,
          "kernel_launches": {"artifact_calls": artifact_launches,
                              "deployment_test": deploy_launches},
          "k1_device_ms_in_artifact_call": k1_device_ms,
          "artifact_call_profile": {k: prof[k] for k in (
              "wall_ms", "device_ms", "device_idle_share",
              "kernel_launches")},
          "host_ms_an_image": {k: statistics.median(v)
                               for k, v in timing.items()},
          "host_ms_all": timing,
          "deployment_test": {"metrics": deployed, "seconds": deploy_s,
                              "val_images": COCO_VAL_IMAGES,
                              "detections": int(raw["valid"].sum())},
          "in_framework": {"metrics": {k: v for k, v in expected.items()
                                       if isinstance(v, float)},
                           "seconds": live_s},
          "metric_max_diff": max(metric_diff.values()),
          "dispatch": dispatch_overhead(seed)})
    return artifact_launches + deploy_launches


# --------------------------------------------------------------------------- #
# the production input path
# --------------------------------------------------------------------------- #
INPUT_SIZE = (960, 1920)  # the panoramas PANDORA ships; the decoder resizes
INPUT_TRAIN_IMAGES = 16   # 4 steps at batch 4
INPUT_VAL_IMAGES = 4      # one evaluation, one K1 launch an image
INPUT_JPEG_QUALITY = 90
INPUT_BOX_BLUR = 6        # px at 1920 wide: smooth chroma (see write_panoramas)
# (name, transfer_colorspace, native decoder on)
INPUT_MODES = (("rgb_native", "rgb", True), ("rgb_pil", "rgb", False),
               ("yuv420", "yuv420", True), ("auto", "auto", True))
I420_BOUND = (1.5, 16.0)  # mean, max pixel error: tests/test_data_eval.py:431
CONVERSION_TOLERANCE = 1e-4  # the card's I420 conversion against the CPU's


def write_panoramas(root: str, split: str, n_images: int, num_classes: int,
                    seed: int) -> tuple[str, str]:
    """A COCO-style set of ``INPUT_SIZE`` panoramas with ``write_coco``'s
    boxes: smooth colour gradients (seeded phases) with each box painted at
    its equirectangular footprint and the whole blurred by
    ``INPUT_BOX_BLUR`` px, so that the chroma is band-limited as in the
    smooth content the JAX package's I420 bound is stated for; the first
    image a PNG, the rest JPEGs at ``INPUT_JPEG_QUALITY``. Returns
    (annotation file, image directory)."""
    from PIL import Image, ImageFilter

    h, w = INPUT_SIZE
    img_dir = os.path.join(root, split)
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    images, annotations = [], []
    for img_id in range(1, n_images + 1):
        phase = rng.uniform(0, 2 * np.pi, 3)
        canvas = np.stack([
            127 + 100 * np.sin(2 * np.pi * xx / w + phase[0]),
            127 + 100 * np.sin(2 * np.pi * yy / h + phase[1]),
            127 + 100 * np.sin(2 * np.pi * (xx / w + yy / h) + phase[2]),
        ], -1).astype(np.uint8)
        for _ in range(int(rng.integers(1, 7))):
            label = int(rng.integers(0, num_classes))
            box = [float(rng.uniform(40.0, 320.0)),
                   float(rng.uniform(50.0, 130.0)),
                   float(rng.uniform(20.0, 60.0)),
                   float(rng.uniform(20.0, 55.0)),
                   float(rng.uniform(-30.0, 30.0))]
            t, p, fx, fy = box[:4]
            canvas[int((p - fy / 2) / 180 * h):int((p + fy / 2) / 180 * h),
                   int((t - fx / 2) / 360 * w):int((t + fx / 2) / 360 * w)] \
                = COCO_CLASS_COLORS[label % len(COCO_CLASS_COLORS)]
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id,
                "category_id": label + 1, "bbox": box, "area": fx * fy,
                "iscrowd": 0})
        image = Image.fromarray(canvas).filter(
            ImageFilter.GaussianBlur(INPUT_BOX_BLUR))
        name = f"{split}_{img_id:04d}." + ("png" if img_id == 1 else "jpg")
        image.save(os.path.join(img_dir, name),
                   **({} if img_id == 1 else {"quality": INPUT_JPEG_QUALITY}))
        images.append({"id": img_id, "file_name": name, "width": w,
                       "height": h})
    ann_file = os.path.join(root, f"{split}.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": i + 1, "name": f"class_{i}"}
                                  for i in range(num_classes)]}, f)
    return ann_file, img_dir + "/"


def traced(fn) -> dict:
    """One profiled call of ``fn``, read from its Chrome trace: wall ms, the
    device's busy ms (the union of its kernels', copies' and sets'
    intervals), the streams that ran kernels (with their counts) and the
    host-to-device copies (stream, bytes)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    intervals = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in device)
    busy_us, end = 0.0, -math.inf
    for a, b in intervals:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    kernel_streams = collections.Counter(
        e["args"].get("stream") for e in device if e["cat"] == "kernel")
    copies = [{"stream": e["args"].get("stream"),
               "bytes": e["args"].get("bytes"), "us": e.get("dur")}
              for e in device if e["cat"] == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "kernel_streams": dict(kernel_streams), "h2d_copies": copies}


def oom_ladder_on_card(seed: int, device) -> dict:
    """``AvoidOOM`` on the card, an out-of-memory error injected: through
    the matcher's ``_pairwise_iou_np`` with the first call failing (the gc
    rung's matrix bitwise the unwrapped one), then with the first two
    failing (the bf16 rung: fp32 values in [0, 1], finite, and its
    warning)."""
    import warnings

    from sph_retina_tpu_torch.engine import eval as eval_mod

    rng = np.random.default_rng(seed)
    dets = seeded_boxes(1000, 5, rng)
    gts = dets[:64] + rng.normal(0.0, 2.0, (64, 5)).astype(np.float32)
    want = eval_mod._pairwise_iou_np(dets, gts, "sph2pob_efficient", device)
    real, out = eval_mod.sph_overlaps, {}
    for name, failures in (("gc_rung", 1), ("bf16_rung", 2)):
        calls = []

        def flaky(a, b, backend):
            calls.append(str(a.dtype))
            if len(calls) <= failures:
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory (injected)")
            return real(a, b, backend)

        eval_mod.sph_overlaps = flaky
        try:
            with warnings.catch_warnings(record=True) as said:
                warnings.simplefilter("always")
                got = eval_mod._pairwise_iou_np(dets, gts,
                                                "sph2pob_efficient", device)
        finally:
            eval_mod.sph_overlaps = real
        out[name] = {"calls": calls, "warnings": [str(w.message)
                                                  for w in said],
                     "dtype": str(got.dtype),
                     "max_abs_diff_to_unwrapped": float(np.abs(
                         got - want).max())}
        if name == "gc_rung" and not (
                calls == ["torch.float32"] * 2 and np.array_equal(got, want)):
            raise AssertionError(f"the gc rung: {out[name]}")
        if name == "bf16_rung" and not (
                calls[-1] == "torch.bfloat16" and got.dtype == np.float32
                and np.isfinite(got).all() and got.min() >= 0.0
                and got.max() <= 1.0
                and any("bfloat16" in w for w in out[name]["warnings"])):
            raise AssertionError(f"the bf16 rung: {out[name]}")
    out["matrix"] = list(want.shape)
    return out


def i420_against_rgb(cfg: dict, device) -> dict:
    """The val split as RGB uint8 and as I420 batches of the same files,
    each converted on the card: the pixel error against the JAX test's
    bound; the card's conversion against the CPU's."""
    std = torch.from_numpy(IMAGENET_STD).to(device)
    batches = {}
    for cs in ("rgb", "yuv420"):
        c = apply_overrides(cfg, [f"data.transfer_colorspace={cs}",
                                  "data.normalize_on_device=True"])
        batches[cs] = next(build_datasets(c, "val")[1].epoch(0))["images"]
    rgb = maybe_normalize_images(torch.from_numpy(batches["rgb"]).to(device))
    i420 = torch.from_numpy(batches["yuv420"])
    on_card = maybe_normalize_images(i420.to(device))
    pix = ((rgb - on_card).abs() * std).float()
    card_vs_cpu = float((on_card.cpu() - maybe_normalize_images(i420))
                        .abs().max())
    return {"images": int(pix.shape[0]),
            "rgb_batch_shape": list(batches["rgb"].shape),
            "i420_batch_shape": list(batches["yuv420"].shape),
            "mean_pixel_error": float(pix.mean()),
            "max_pixel_error": float(pix.max()),
            "card_vs_cpu_max_abs": card_vs_cpu}


def noise_panorama_i420_error(tmp: str, seed: int, device) -> dict:
    """Not gated: the same comparison on one ``write_coco`` noise panorama
    (per-pixel colour noise and sharp box edges) saved as a JPEG, where
    4:2:0 chroma cannot hold what RGB holds."""
    from PIL import Image

    ann, img_dir = write_coco(os.path.join(tmp, "noise"), "val", 1, 3,
                              INPUT_SIZE, seed)
    (name,) = os.listdir(img_dir)
    jpg = os.path.join(img_dir, "noise.jpg")
    Image.open(os.path.join(img_dir, name)).save(
        jpg, quality=INPUT_JPEG_QUALITY)
    item = {"img_path": jpg, "boxes": np.zeros((0, 5), np.float32),
            "labels": np.zeros((0,), np.int32)}
    out = {}
    for cs in ("rgb", "yuv420"):
        pipe = SphPipeline(img_size=(512, 1024), box_version=5,
                           training=False, normalize_on_device=True,
                           transfer_colorspace=cs)
        out[cs] = maybe_normalize_images(torch.from_numpy(
            pipe(item, np.random.default_rng(0))["images"]).to(device))
    std = torch.from_numpy(IMAGENET_STD).to(device)
    pix = (out["rgb"] - out["yuv420"]).abs() * std
    return {"mean_pixel_error": float(pix.mean()),
            "max_pixel_error": float(pix.max())}


def measure_input_mode(parts, device) -> dict:
    """On the trainer's own loader, model and step after its run: the
    loader's images a second (host clock, an epoch of its threads), the
    bytes and host ms of each batch's transfer (pinned staging, a copy
    stream, to its synchronisation), step ms (events, host clock), and one
    profiled window of two steps fed by ``prefetch_to_device``."""
    loader, step = parts["loader"], parts["step"]
    t0 = time.perf_counter()
    host = list(loader.epoch(1))
    loader_s = time.perf_counter() - t0
    images = sum(len(b["images"]) for b in host)
    staging, stream = PinnedStaging(), torch.cuda.Stream()

    def transfer(b):
        return to_device({k: v for k, v in b.items() if k != "img_id"},
                         device, staging)

    h2d_ms, on_card = [], None
    for b in host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            on_card = transfer(b)
        stream.synchronize()
        h2d_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.current_stream().wait_stream(stream)
    timed = timed_steps(step, on_card, 3)

    def convert_all():
        for b in prefetch_to_device(iter(host), transfer, device=device):
            maybe_normalize_images(b["images"])

    def two_steps():
        for b in prefetch_to_device(iter(host[:2]), transfer, device=device):
            step(b)

    # The copies' streams from a window of transfers alone, the images
    # converted on the consumer's stream. On the card the trace loses some
    # large-copy records once earlier work in the process has been profiled
    # (also for copies from the main thread), so the gate takes those it
    # caught: at least one, and none on the consumer's stream.
    copies = traced(convert_all)
    window = traced(two_steps)
    batch_image_bytes = int(host[0]["images"].nbytes)
    compute = max(copies["kernel_streams"], key=copies["kernel_streams"].get)
    batch_copies = [c for c in copies["h2d_copies"]
                    if c["bytes"] == batch_image_bytes]
    if not batch_copies or any(c["stream"] == compute
                               for c in batch_copies):
        raise AssertionError(
            f"the image batches' H2D copies {batch_copies} against the "
            f"consumer's stream {compute} (kernels by stream "
            f"{copies['kernel_streams']}; {batch_image_bytes} bytes a "
            f"batch; every copy {copies['h2d_copies']})")
    return {"loader_images_per_sec": images / loader_s,
            "loader_epoch_seconds": loader_s,
            "batch_image_bytes": batch_image_bytes,
            "batch_bytes": int(sum(v.nbytes for k, v in host[0].items()
                                   if k != "img_id")),
            "batch_image_shape": list(host[0]["images"].shape),
            "h2d_host_ms": statistics.median(h2d_ms), "h2d_host_ms_all": h2d_ms,
            "step_ms": {k: timed[k] for k in ("first_step_ms",
                                              "steady_step_ms")},
            "two_step_window": {
                "wall_ms": window["wall_ms"],
                "device_busy_ms": window["device_busy_ms"],
                "device_busy_share": window["device_busy_ms"]
                / window["wall_ms"],
                "kernel_streams": window["kernel_streams"]},
            "consumer_stream": compute, "image_batch_copies": batch_copies,
            "image_batch_copies_made": len(host)}


def phase_train_input(seed: int, reps: int) -> tuple[int, dict]:
    """The production input path at full width: the rotated R50 config
    trains 4 steps with one evaluation on ``INPUT_SIZE`` JPEG panoramas
    (and one PNG) through ``train.main`` in each of ``INPUT_MODES``: the
    native decoder (or PIL, where it cannot be built), packed-I420
    transfer, the ``auto`` policy; transfers on the copy stream. Gates: every
    image of a native run read by the decoder; K1 once a step and once a
    val image, equal to its plain version; the I420 batch within the JAX
    test's bound of the RGB batch on the card, the card's conversion within
    ``CONVERSION_TOLERANCE`` of the CPU's; the image batches' copies on a
    stream other than the compute stream; the injected OOM's rungs.
    Returns K1's launches over the four runs and its check on the last
    assignment input."""
    device = resolve_device()
    status = native_loader.status()
    emit({"phase": "native_decoder", **status})
    cfg = load_config(CONFIG)
    classes = cfg["model"]["num_classes"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        train_ann, train_dir = write_panoramas(tmp, "train",
                                               INPUT_TRAIN_IMAGES, classes,
                                               seed)
        val_ann, val_dir = write_panoramas(tmp, "val", INPUT_VAL_IMAGES,
                                           classes, seed + 1)
        write_seconds = time.perf_counter() - t0
        data = [f"data.train.ann_file={train_ann}",
                f"data.train.img_prefix={train_dir}",
                f"data.val.ann_file={val_ann}",
                f"data.val.img_prefix={val_dir}"]
        data_cfg = apply_overrides(cfg, data)

        real = {"build": train_cli.build_training,
                "eval": train_cli.evaluate_dataset,
                "probe": policy._probe_host_rates}
        modes, assign_calls, nms_calls = [], [], []
        last_assign = []
        for name, colorspace, native in INPUT_MODES:
            parts, evals, probe_decodes = {}, [], [0]

            def building(*a, **kw):
                built = real["build"](*a, **kw)
                parts.update(zip(("model", "det_cfg", "loader", "optimizer",
                                  "step"), built))
                return built

            def timed_eval(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real["eval"](*a, **kw)
                evals.append(time.perf_counter() - t0)
                return out

            def probing(*a, **kw):
                before = native_loader.status()["images"]
                out = real["probe"](*a, **kw)
                probe_decodes[0] += native_loader.status()["images"] - before
                return out

            train_cli.build_training = building
            train_cli.evaluate_dataset = timed_eval
            policy._probe_host_rates = probing
            single_stage.sph2pob_iou_pairwise = _recording(
                _recording(sph2pob_iou_pairwise, assign_calls),
                last_assign, keep_last=True)
            nms_module.sph2pob_iou_pairwise = _recording(
                sph2pob_iou_pairwise, nms_calls)
            decoded0 = native_loader.status()["images"]
            sph2pob_iou_pairwise.launches = 0
            try:
                t0 = time.perf_counter()
                said = _said(lambda: train_cli.main([
                    CONFIG, "--seed", str(seed), "--max-epochs", "1",
                    "--work-dir", os.path.join(tmp, name), "--cfg-options",
                    "evaluation.interval=1", "log_config.interval=1",
                    f"data.transfer_colorspace={colorspace}",
                    "data.normalize_on_device=True",
                    f"data.native_decoder={native}", *data]))
                run_seconds = time.perf_counter() - t0
            finally:
                train_cli.build_training = real["build"]
                train_cli.evaluate_dataset = real["eval"]
                policy._probe_host_rates = real["probe"]
                single_stage.sph2pob_iou_pairwise = sph2pob_iou_pairwise
                nms_module.sph2pob_iou_pairwise = sph2pob_iou_pairwise
            launches = sph2pob_iou_pairwise.launches
            decoded = native_loader.status()["images"] - decoded0 \
                - probe_decodes[0]
            with open(os.path.join(tmp, name, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
            steps = [r for r in records if r["prefix"] == "train"]
            vals = [r for r in records if r["prefix"] == "val"]
            chosen = parts["loader"].pipeline.transfer_colorspace
            uses_native = native and status["available"]
            want_decoded = INPUT_TRAIN_IMAGES + INPUT_VAL_IMAGES \
                if uses_native else 0
            if decoded != want_decoded:
                raise AssertionError(
                    f"{name}: the native decoder read {decoded} images, "
                    f"{want_decoded} expected (status {status})")
            steps_per_run = INPUT_TRAIN_IMAGES // TRAIN_BATCH
            if launches != steps_per_run + INPUT_VAL_IMAGES or \
                    [s["step"] for s in steps] != list(
                        range(1, steps_per_run + 1)) or len(vals) != 1:
                raise AssertionError(
                    f"{name}: {launches} K1 launches, steps {steps}, "
                    f"val records {vals}")
            if not all(math.isfinite(r["loss"]) for r in steps):
                raise AssertionError(f"{name}: a loss is not finite: {steps}")
            if "native decoder compiler" not in said:
                raise AssertionError(f"{name}: no environment in {said!r}")
            mode = {"mode": name, "transfer_colorspace": chosen,
                    "decoder": "native" if uses_native else "PIL",
                    "native_images": decoded, "run_seconds": run_seconds,
                    "kernel_launches": launches,
                    "losses": [r["loss"] for r in steps],
                    "evaluation_seconds": evals[0],
                    "val_record": {k: vals[0][k] for k in ("mAP", "AP50")},
                    **measure_input_mode(parts, device)}
            if colorspace == "auto":
                mode["auto_probe"] = policy.resolve_transfer_colorspace \
                    .last_probe
                mode["probe_native_decodes"] = probe_decodes[0]
            modes.append(mode)
            emit({"phase": "train_input_mode", **mode})
            del parts
        # each read just after its run, before the measurements' own steps
        total_launches = sum(m["kernel_launches"] for m in modes)

        want_assign = [list(ASSIGN_SHAPE[::2]), list(ASSIGN_SHAPE[1:])]
        if assign_calls != [want_assign] * (
                len(INPUT_MODES) * INPUT_TRAIN_IMAGES // TRAIN_BATCH):
            raise AssertionError(f"assignment calls {assign_calls}")
        if len(nms_calls) != len(INPUT_MODES) * INPUT_VAL_IMAGES or any(
                a != b or a[0] > 1000 or a[1] != 5 for a, b in nms_calls):
            raise AssertionError(f"NMS calls {nms_calls}")
        bound = i420_against_rgb(data_cfg, device)
        if not (bound["mean_pixel_error"] < I420_BOUND[0]
                and bound["max_pixel_error"] < I420_BOUND[1]):
            raise AssertionError(f"I420 against RGB on the card: {bound}")
        if not bound["card_vs_cpu_max_abs"] <= CONVERSION_TOLERANCE:
            raise AssertionError(f"the card's I420 conversion: {bound}")
        noise = noise_panorama_i420_error(tmp, seed, device)

    (_, b1, b2), = last_assign
    on_assign = {"input": "train_input: the last assignment input",
                 **check_kernel(KERNELS[0], b1, b2, reps, identical=False)}
    oom = oom_ladder_on_card(seed, device)
    emit({"phase": "train_input", "config": os.path.relpath(CONFIG, ROOT),
          "panorama_size": list(INPUT_SIZE), "train_images":
          INPUT_TRAIN_IMAGES, "val_images": INPUT_VAL_IMAGES,
          "jpeg_quality": INPUT_JPEG_QUALITY, "box_blur_px": INPUT_BOX_BLUR,
          "dataset_write_seconds": write_seconds,
          "native_decoder_available": status["available"],
          "modes": [{k: m[k] for k in (
              "mode", "transfer_colorspace", "decoder",
              "loader_images_per_sec", "batch_image_bytes", "h2d_host_ms",
              "step_ms", "evaluation_seconds")} for m in modes],
          "i420_vs_rgb_on_card": bound, "i420_bound": list(I420_BOUND),
          "noise_panorama_i420_error_not_gated": noise,
          "kernel_launches": total_launches, "oom_ladder": oom,
          "kernel_on_assignment_input": on_assign})
    return total_launches, on_assign



def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20,
                   help="timed launches per kernel and shape (median)")
    p.add_argument("--fmad-probe", action="store_true",
                   help="also build the pairwise kernel with FMA contraction "
                        "and report its error and time beside the shipped "
                        "build")
    p.add_argument("--assign-probe", action="store_true",
                   help="only the device line and the eager sph2pob_standard "
                        "assignment of the indoor360 config at full width")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1

    kind, smi = phase_device()
    if args.assign_probe:
        emit({"phase": "assign_probe", **assign_probe(args.seed)})
        return 0
    phase_build()
    shapes = phase_kernels(args.seed, args.reps)
    if args.fmad_probe:
        emit({"phase": "fmad_probe", **fmad_probe(args.seed, args.reps)})
    launches = {k.name: 0 for k in KERNELS}
    launches["sph2pob_iou_aligned"] += phase_iou_tool()
    served, det, images, on_nms_input = phase_serve(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += served
    phase_breakdown(det, images[-1], args.reps)
    del det
    trained, on_assign_input = phase_train(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    trained, on_iou_input = phase_train_iou_loss(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    phase_serve_unbiased(args.seed)
    trained, on_ssd_input = phase_train_ssd(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    phase_train_kent(args.seed)
    phase_train_fcos(args.seed)
    phase_serve_families(args.seed)
    trained, on_frcnn_input = phase_train_frcnn(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    trained, on_val_nms_input = phase_train_coco(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    launches["sph2pob_iou_pairwise"] += phase_export(args.seed, args.reps)
    trained, on_input_assign = phase_train_input(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    # K1 on the inputs its paths gave it, beside its seeded shapes
    shapes["sph2pob_iou_pairwise"] += [on_nms_input, on_assign_input,
                                       on_iou_input, on_ssd_input,
                                       *on_frcnn_input, on_val_nms_input,
                                       on_input_assign]
    idle = [k.name for k in KERNELS if launches[k.name] < 1]
    if idle:
        raise AssertionError(f"no main path launched {idle}")

    summary = []
    for k in KERNELS:
        main_shape = next(r for r in shapes[k.name]
                          if r["shape"] == list(k.main_shape))
        summary.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": max(r["max_abs_err"] for r in shapes[k.name]),
            "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"], "library_ms": None,
            "shape": main_shape["shape"], "tolerance": TOLERANCE,
            "shapes": shapes[k.name]})
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --fmad-probe # also: K1 built with FMA contraction
    python3 chip_smoke.py --assign-probe  # only: the eager sph2pob_standard
                                          # assignment at the R50 width
    python3 chip_smoke.py --study      # only: the full sphere-bench study,
                                       # RetinaNet l1 and ciou, 24 epochs

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
evaluation's OOM ladder) on 960x1920 panoramas; pretrained weights and
result analysis (``--load-backbone`` from torchvision-layout ResNet-50 and
VGG16 files, ``test.py --save-raw``, the four analysis tools on the card and
on the CPU, an mmdet checkpoint converted and served); the
corruption-robustness benchmark and the offline scoring tools
(``test_robustness``, ``robustness_eval``, ``eval_metric``,
``eval_pr_curve``) on 960x1920 panoramas without OpenCV; drawing, demos
and anchor optimisation (``image_demo``, ``show_result``, the perspective
camera, ``optimize_anchors``, ``vis_kent``, the plots, ``analyze_logs``,
``create_result_gif``, ``browse_dataset``, every figure without
matplotlib); the measurement tools (``print_config``, ``get_flops``,
``benchmark_fps``, ``profile_step`` with the backbone's ``remat`` off and
on, ``mfu_experiment``, ``bench_host_pipeline``); the sphere-bench study
tools (``assign_audit`` on the committed annotations against the published
audit, ``ap_study --quick``, ``detection_diagnosis``), the dataset
converters and the torchrun launchers; ``parallel/sharding.py`` (FSDP, the
width-sharded "space" axis, the row-sharded overlaps); the video and webcam
demos on Motion-JPEG ``.avi`` and ``.mp4`` files of the port's own video
layer; and the IoU tool
(``benchmark_iou.main``, the kernel and the other backends) — and holds
every CUDA kernel of those paths against its plain PyTorch version on the
card.

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
17. pretrained  ``train.main --load-backbone`` of a seeded torchvision-
            layout ResNet-50 file on the rotated config, 4 steps: the
            backbone the file's before the first step, the frozen stem and
            stage 1 and every batch-norm statistic still the file's after
            the last, K1 once a step; ``test.main --synthetic --save-raw``
            (K1 once a val image; the raw file's keys); the four analysis
            tools on it with ``--device cuda`` and ``cpu`` (integers equal,
            floats within 1e-6; the plotting tools' figures written); a
            seeded mmdet RetinaNet-R50 checkpoint through
            ``convert_reference_checkpoint``
            and 3 requests (K1 once each, bitwise the detector loaded from
            ``port_mmdet_retinanet``); the SSD config from a seeded VGG16
            file, 2 steps (the 13 convs the file's, conv6 / conv7 / L2Norm
            initialised, K1 once a step at (256, 49056) D=4)
18. parallel  multi-process data parallelism on the rotated config: (a)
            ``train.main --launcher torch`` at world 1 over NCCL (torchrun's
            variables set in this process), 4 steps, one evaluation and a
            checkpoint, its parameters bitwise those of ``--launcher none``,
            the gathered evaluation's 16 images and metrics those of the
            ungathered one, K1 once a step at (256, 98208), the checkpoint
            restored bitwise; (b) two ranks sharing the card over gloo, each
            a process of its own (deadline 240 s, both killed on a failure):
            2 steps at batch 2 in fp32 (TF32 off) and one evaluation, the
            ranks' parameters bitwise alike after every step, their update
            within ``PARALLEL_TOLERANCE`` of one process's at batch 4 on the
            same 8 images, K1 once a step a rank at (128, 98208), 8 images
            after the gather's de-duplication, only rank 0 writing; the
            gradient all-reduce's ms a step in both
19. robustness  the corruption-robustness benchmark and the offline scoring
            tools on the rotated config, ``cv2`` made unimportable, on 4
            960x1920 panoramas it writes: each of the 15 corruptions at
            severity 3 on the host (ms an image, median of 4; the same bytes
            twice; a mean change over 0.5 level); a checkpoint from 2 steps
            of ``train.main``; ``test_robustness.main --corruptions
            benchmark --severities 0 3`` (16 evaluations: seconds, the
            loader's images a second, K1 once a val image in each; the JAX
            package's JSON layout, finite metrics) and ``robustness_eval``;
            ``test.main --save-raw`` (metrics within 1e-4 of the tool's clean
            entry); ``eval_metric`` on the raw file (within 1e-6 of
            ``test.main``'s); ``eval_pr_curve`` (its figure written; K1
            once a val image); K1
            bitwise its plain version on the last NMS input
20. visualize  drawing, demos and anchor optimisation on the rotated
            config: ``train.main`` 2 steps (K1 once a step; its log for
            ``analyze_logs``); ``image_demo.main`` on a 960x1920 PNG
            panorama with a checkpoint of seeded, calibrated weights (load,
            read, predict, draw and save timed apart; a detection drawn; K1
            once; the PNG bitwise ``show_result(det, img,
            inference_detector(det, img))``, K1 once more; K1 bitwise its
            plain version on the demo's NMS input); the perspective
            camera's views on the card within 1 level of the CPU's, ms
            each; ``optimize_anchors --synthetic``: k-means on the card
            within 1e-3 degree of the CPU, differential evolution (200
            generations, population 48, K = 45) no worse than the config's
            anchors, seconds and peak memory; ``vis_kent``, the IoU scatter
            and curve plots, ``analyze_logs``, ``create_result_gif``,
            ``browse_dataset``: every file written, neither matplotlib nor
            imageio imported
21. measure  the measurement tools on the rotated config at full width,
            each through its ``main(argv)``: ``print_config`` (its text's
            sha256); ``get_flops`` at 512x1024 (37,304,852 parameters,
            0.21-0.23 TFLOP, the count on the card equal to the meta
            device's and, at 128x256, to the CPU's); ``benchmark_fps`` at
            batch 1 and 8, with and without ``--with-nms`` (images a second;
            K1 once an image a call, bitwise at the last NMS input);
            ``profile_step`` at batch 4: the trace (bytes, kernel events,
            K1's), ``--breakdown``, ``--memory`` (``remat`` lowers the peak,
            the step's loss the same within 1e-3); K1 bitwise at its
            assignment input (64, 98208) D=5; ``mfu_experiment
            --experiments baseline`` in its own child process (step ms,
            images a second, 0 < mfu <= 1.05, the card's name and power
            limit; K1 bitwise at the child's assignment input (128, 98208)
            D=4); ``bench_host_pipeline`` at 512x1024, 16 images, workers
            1 2 4, the link probe
22. study  the sphere-bench study tools, the converters and the
            launchers: ``assign_audit.main`` on the committed train
            annotations (500 images, 5 backends and the unbiased oracle,
            batch 8; seconds and a table row a backend) held to the
            published ``work_dirs/assign_audit/audit.json`` (GTs and
            anchors exactly, positives a GT within 1 %, flip rates within
            1e-3, the oracle's 0.0, the published findings), K1 63 times
            at (88, 24552) D=4 and bitwise on the last batch;
            ``ap_study.main --quick`` (six RetinaNet variants, 2 epochs at
            128x256, data written under its output: seconds and AP50 each;
            K1 once a step in ``l1`` and ``ciou`` at (192, 6138) D=4, never
            in the others; the published report's keys, every
            ``eval_arrays.npz``); ``detection_diagnosis`` on those runs
            and on one of the val ground truth jittered into detections,
            on the card and on the CPU (integers equal, floats within
            1e-6, detections counted); the seven
            converters on files the phase writes; ``scripts/dist_train.sh
            CONFIG 1 --synthetic`` (2 steps under torchrun, K1 once a step
            at (256, 98208) D=5 as the child reports it, bitwise on its
            last input) and ``scripts/dist_test.sh`` on its checkpoint (K1
            once a val image); the committed annotations' sha256 unchanged
23. sharding  ``parallel/sharding.py`` on the rotated config at full width:
            (a) ``shard_state_fsdp`` at world 1 over NCCL (a (1, 1) mesh),
            4 steps at batch 4 against one process without a group of the
            same seed (the largest parameter gap, within
            ``PARALLEL_TOLERANCE``; K1 once a step at (256, 98208) D=5);
            then two ranks sharing the card over gloo, processes of their
            own (deadline ``SHARDING_CHILD_S``): (b) FSDP over data 2, 2
            steps at batch 2 a rank in fp32 (TF32 off), the update within
            ``PARALLEL_TOLERANCE`` of one process's at batch 4 on the same
            images, each rank's bytes of parameters, momentum and EMA beside
            the unsharded bytes, rank 0's checkpoint loaded into a model of
            one process equal to the gathered parameters; (c) data 1 x
            space 2 through the split RetinaNet head, 2 steps at batch 2:
            each step's loss within 1e-4 of one process's, the update
            within ``PARALLEL_TOLERANCE``, K1 once a step a rank at
            (128, 49104) D=5 against the rank's own anchors, bitwise on
            rank 0's last input, the two ranks' last labels joined equal to
            one process's, and the trained model's ``predict_fn`` on the
            whole last batch (its classifier scaled so that detections
            are made) equal to one process's of the same weights (valid
            detections, labels and indices equal, boxes, scores and the
            head's joined outputs within rtol 1e-3 / atol 1e-4); (d)
            ``sharded_pairwise_overlaps`` of the
            config's 98 208 anchors against 256 seeded boxes over the two
            ranks, within rtol 1e-5 / atol 1e-6 of the unsharded
            ``sph_overlaps``, each rank's ms; (e) the FCOS config through
            its split head, data 1 x space 2, 2 steps at batch 2 in fp32
            against one process on the same images (losses 1e-4, the update
            within ``PARALLEL_TOLERANCE``); (f) the SSD config through its
            gathered head (the neck's outputs gathered, the loss scaled by
            1/2), the same steps and gates, K1 once a step a rank at
            (128, 49056) D=4, bitwise on rank 0's last input; a line before
            the phase's own gives, for (c) and (e), each rank's head
            columns, bytes allocated at the start and peak memory, forward
            FLOPs at batch 1 and steady step ms beside one process's and
            the card's name and power limit, and each run's three largest
            transients of a module's forward in its first step
24. video  the video and webcam demos on the rotated config at full
            width: 24 960x1920 panoramas written at 30 fps by the port's
            ``VideoWriter`` as Motion JPEG in ``.avi`` and ``.mp4``;
            ``video_demo.main`` on the ``.avi`` at ``--batch 8`` and on the
            ``.mp4`` with ``--max-frames 8``, ``webcam_demo.main --source``
            the ``.avi`` ``--out DIR --max-frames 8`` (seeded, calibrated
            weights): each output read back by ``open_video`` with the
            frame count, 1024x512 and 30 fps, each frame bit for bit the
            JPEG of its ``show_result`` array and within
            ``VIDEO_JPEG_TOLERANCE`` of it; ``--camera-id 0``'s ``cannot
            open camera 0`` where ``/dev/video0`` is missing (else 8 frames
            from it); K1 once a frame, 40 launches, bitwise on the last NMS
            input; host ms a frame for read and decode, predict, draw and
            encode, frames a second end to end
25. the kernels' summary line, then the last line
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
import hashlib
import io
import itertools
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sph_retina_tpu_torch import analyze_logs as logs_cli
from sph_retina_tpu_torch import analyze_results as analyze_cli
from sph_retina_tpu_torch import ap_study as ap_cli
from sph_retina_tpu_torch import apis
from sph_retina_tpu_torch import assign_audit as audit_cli
from sph_retina_tpu_torch import bench_host_pipeline as host_cli
from sph_retina_tpu_torch import benchmark_fps as fps_cli
from sph_retina_tpu_torch import benchmark_iou
from sph_retina_tpu_torch import browse_dataset as browse_cli
from sph_retina_tpu_torch import cityscapes as city_cli
from sph_retina_tpu_torch import coco_error_analysis as error_cli
from sph_retina_tpu_torch import confusion_matrix as confusion_cli
from sph_retina_tpu_torch import convert_anno as anno_cli
from sph_retina_tpu_torch import convert_reference_checkpoint as convert_cli
from sph_retina_tpu_torch import create_result_gif as gif_cli
from sph_retina_tpu_torch import deployment_test as deployment_cli
from sph_retina_tpu_torch import detection_diagnosis as diag_cli
from sph_retina_tpu_torch import eval_metric as metric_cli
from sph_retina_tpu_torch import eval_pr_curve as pr_cli
from sph_retina_tpu_torch import export as export_cli
from sph_retina_tpu_torch import get_flops as flops_cli
from sph_retina_tpu_torch import get_image_metas as metas_cli
from sph_retina_tpu_torch import image_demo as demo_cli
from sph_retina_tpu_torch import images2coco as images_cli
from sph_retina_tpu_torch import mfu_experiment as mfu_cli
from sph_retina_tpu_torch import occluded_recall as recall_cli
from sph_retina_tpu_torch import optimize_anchors as anchors_cli
from sph_retina_tpu_torch import parallel
from sph_retina_tpu_torch import pascal_voc as voc_cli
from sph_retina_tpu_torch import print_config as config_cli
from sph_retina_tpu_torch import profile_step as profile_cli
from sph_retina_tpu_torch import publish as publish_cli
from sph_retina_tpu_torch import robustness_eval as summary_cli
from sph_retina_tpu_torch import split_coco as split_cli
from sph_retina_tpu_torch import synth_dataset as synth_cli
from sph_retina_tpu_torch import test as test_cli
from sph_retina_tpu_torch import test_robustness as robust_cli
from sph_retina_tpu_torch import train as train_cli
from sph_retina_tpu_torch import video_demo as video_cli
from sph_retina_tpu_torch import vis_kent as kent_cli
from sph_retina_tpu_torch import webcam_demo as webcam_cli
from sph_retina_tpu_torch.apis import (
    inference_detector,
    init_detector,
    show_result,
)
from sph_retina_tpu_torch.boxes import nms as nms_module
from sph_retina_tpu_torch.engine import evaluator, runner
from sph_retina_tpu_torch.engine import train as engine_train
from sph_retina_tpu_torch.engine.analysis import (
    confusion_matrix,
    load_raw_results,
    per_image_scores,
    save_raw_results,
)
from sph_retina_tpu_torch.engine.builder import build_datasets, build_tx
from sph_retina_tpu_torch.engine.eval import eval_spherical_map
from sph_retina_tpu_torch.engine.zoo import get_family, make_generic_train_step
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.data import (
    DataLoader,
    PinnedStaging,
    SphCocoDataset,
    SphPipeline,
    make_synthetic_dataset,
    native_loader,
    policy,
    prefetch_to_device,
    to_device,
)
from sph_retina_tpu_torch.data import video as video_io
from sph_retina_tpu_torch.data.corruptions import (
    BENCHMARK_CORRUPTIONS,
    corrupt,
)
from sph_retina_tpu_torch.data.pipeline import (
    IMAGENET_STD,
    maybe_normalize_images,
)
from sph_retina_tpu_torch.iou import sph_overlaps
from sph_retina_tpu_torch.losses import (
    sph2pob_iou_loss,
    sph_kent_loss,
    sph_l1_loss,
)
from sph_retina_tpu_torch.models import (
    faster_rcnn,
    port_mmdet_retinanet,
    single_stage,
)
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
from sph_retina_tpu_torch.utils.publish import load_published
from sph_retina_tpu_torch.visualize import (
    PerspectiveCamera,
    plot_curve,
    plot_iou_scatter,
)

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
# the measurement tools' assignments: profile_step's batch 4 x 16 GT on the
# rotated config, mfu_experiment's batch 8 x 16 GT on the base config
PROFILE_ASSIGN_SHAPE = (64, 98208, 5)
MFU_ASSIGN_SHAPE = (128, 98208, 4)
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


def drive_trainer(config: str, steps: int, batch: int, seed: int,
                  extra=(), work: str | None = None, options=()) -> dict:
    """``train.main`` as a user starts it, one epoch of ``steps`` steps,
    logging every step, with the arguments ``extra`` and the config options
    ``options`` added; in the
    directory ``work`` (kept), else in a temporary one. The pairwise
    kernel's launch counter is set to 0 just before and read just after;
    its calls are recorded (shapes, and the inputs of the last call of each
    shape). Returns the config, what ``build_training`` built, the per-step
    log records, the kernel's launches and calls, the trainer's output and
    wall time."""
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
        with (contextlib.nullcontext(work) if work else
              tempfile.TemporaryDirectory(
                  dir=os.path.join(ROOT, "build"))) as work:
            sph2pob_iou_pairwise.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(said):
                rc = train_cli.main([
                    config, "--synthetic", "--seed", str(seed),
                    "--max-epochs", "1", "--work-dir", work, *extra,
                    "--cfg-options", f"data.n_synthetic={steps * batch}",
                    "log_config.interval=1", *options])
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
            "last_inputs": last_inputs, "said": said.getvalue(),
            "seconds": seconds}


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
                    seed: int, grain: int = 0) -> tuple[str, str]:
    """A COCO-style set of ``INPUT_SIZE`` panoramas with ``write_coco``'s
    boxes: smooth colour gradients (seeded phases) with each box painted at
    its equirectangular footprint and the whole blurred by
    ``INPUT_BOX_BLUR`` px, so that the chroma is band-limited as in the
    smooth content the JAX package's I420 bound is stated for; with
    ``grain``, seeded uniform noise of up to ``grain`` levels added after
    the blur (a texture for blurs to act on); the first image a PNG, the
    rest JPEGs at ``INPUT_JPEG_QUALITY``. Returns (annotation file, image
    directory)."""
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
        if grain:
            noise = rng.integers(-grain, grain + 1, (h, w, 3))
            image = Image.fromarray(np.clip(np.asarray(image, np.int16)
                                            + noise, 0, 255).astype(np.uint8))
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


# --------------------------------------------------------------------------- #
# pretrained weights and result analysis
# --------------------------------------------------------------------------- #
PRETRAINED_STEPS = 4        # the rotated R50 config from a loaded backbone
PRETRAINED_SSD_STEPS = 2    # the SSD config from a loaded VGG16
PRETRAINED_REQUESTS = 3     # to the detector of a converted mmdet checkpoint
PRETRAINED_VAL_IMAGES = 16  # test.py --synthetic
TOOL_TOLERANCE = 1e-6       # card vs CPU, as for the mAP (phase train_coco)
RAW_KEYS = {"boxes", "scores", "labels", "valid", "gt_boxes", "gt_labels",
            "gt_mask", "ig_boxes", "ig_labels", "ig_mask", "img_id"}
RESNET50_STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))
VGG16_FEATURES = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
                  (10, 128, 256), (12, 256, 256), (14, 256, 256),
                  (17, 256, 512), (19, 512, 512), (21, 512, 512),
                  (24, 512, 512), (26, 512, 512), (28, 512, 512))


def _he(rng, *shape) -> torch.Tensor:
    fan_in = math.prod(shape[1:])
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            * np.float32(math.sqrt(2.0 / fan_in)))


def _torch_bn(sd: dict, name: str, c: int, rng, scale: float = 1.0) -> None:
    """A batch norm as torch saves it: random affine parameters and running
    statistics (variance in [0.5, 1.5)), and ``num_batches_tracked``."""
    f32 = np.float32
    sd[f"{name}.weight"] = torch.from_numpy(
        (scale * rng.uniform(0.8, 1.2, c)).astype(f32))
    sd[f"{name}.bias"] = torch.from_numpy(rng.normal(0, 0.05, c).astype(f32))
    sd[f"{name}.running_mean"] = torch.from_numpy(
        rng.normal(0, 0.1, c).astype(f32))
    sd[f"{name}.running_var"] = torch.from_numpy(
        rng.uniform(0.5, 1.5, c).astype(f32))
    sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)


def torchvision_resnet50(seed: int, fc: bool = True) -> dict:
    """A seeded ``state_dict`` with torchvision ResNet-50's key names and
    shapes, built from its stage layout (no torchvision on the card's
    host): He-normal convs, random batch norms (the last of each block
    scaled by 0.3, so that activations do not grow a block), ``fc``."""
    rng = np.random.default_rng(seed)
    sd = {"conv1.weight": _he(rng, 64, 3, 7, 7)}
    _torch_bn(sd, "bn1", 64, rng)
    inplanes = 64
    for s, (planes, blocks) in enumerate(RESNET50_STAGES):
        for b in range(blocks):
            p = f"layer{s + 1}.{b}"
            for i, (cout, cin, k) in enumerate(
                    ((planes, inplanes, 1), (planes, planes, 3),
                     (planes * 4, planes, 1)), 1):
                sd[f"{p}.conv{i}.weight"] = _he(rng, cout, cin, k, k)
                _torch_bn(sd, f"{p}.bn{i}", cout, rng, 0.3 if i == 3 else 1.0)
            if b == 0:
                sd[f"{p}.downsample.0.weight"] = _he(rng, planes * 4,
                                                     inplanes, 1, 1)
                _torch_bn(sd, f"{p}.downsample.1", planes * 4, rng)
            inplanes = planes * 4
    if fc:
        sd["fc.weight"] = _he(rng, 1000, 2048)
        sd["fc.bias"] = torch.zeros(1000)
    return sd


def torchvision_vgg16(seed: int) -> dict:
    """A seeded ``state_dict`` with torchvision VGG16's key names and
    shapes: the 13 ``features`` convs He-normal with small biases, the
    ``classifier`` at its shapes (zeros: nothing reads it)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, cin, cout in VGG16_FEATURES:
        sd[f"features.{idx}.weight"] = _he(rng, cout, cin, 3, 3)
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(0, 0.01, cout).astype(np.float32))
    for idx, cin, cout in ((0, 25088, 4096), (3, 4096, 4096),
                           (6, 4096, 1000)):
        sd[f"classifier.{idx}.weight"] = torch.zeros(cout, cin)
        sd[f"classifier.{idx}.bias"] = torch.zeros(cout)
    return sd


def mmdet_retinanet_r50(seed: int, num_classes: int, box_version: int,
                        channels: int = 256, anchors: int = 9) -> dict:
    """A seeded mmdet RetinaNet-R50 ``state_dict``: torchvision's backbone
    under ``backbone.``, ``neck.lateral_convs`` / ``fpn_convs`` (the two
    ``add_extra_convs='on_input'`` convs last), the head's four
    ``{cls,reg}_convs`` a tower and ``retina_cls`` / ``retina_reg``; the
    class bias spread around -1, so that the detector detects."""
    rng = np.random.default_rng(seed)
    sd = {f"backbone.{k}": v
          for k, v in torchvision_resnet50(seed, fc=False).items()}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = _he(rng, cout, cin, k, k)
        sd[f"{name}.bias"] = torch.zeros(cout)

    for i, cin in enumerate((512, 1024, 2048)):
        conv(f"neck.lateral_convs.{i}.conv", channels, cin, 1)
        conv(f"neck.fpn_convs.{i}.conv", channels, channels, 3)
    conv("neck.fpn_convs.3.conv", channels, 2048, 3)
    conv("neck.fpn_convs.4.conv", channels, channels, 3)
    for tower in ("cls", "reg"):
        for i in range(4):
            conv(f"bbox_head.{tower}_convs.{i}.conv", channels, channels, 3)
    conv("bbox_head.retina_cls", anchors * num_classes, channels, 3)
    conv("bbox_head.retina_reg", anchors * box_version, channels, 3)
    sd["bbox_head.retina_cls.bias"] = torch.from_numpy(
        rng.normal(-1.0, 1.0, anchors * num_classes).astype(np.float32))
    return sd


def torchvision_to_port_name(key: str) -> str | None:
    """torchvision's ResNet key -> the port's backbone key, or None for
    what the backbone has no place for (``fc.*``, ``num_batches_tracked``).
    Written here from the two layouts, apart from ``port_torchvision_
    weights``, so that the gates do not take the porter's word."""
    if key.startswith("fc.") or key.endswith("num_batches_tracked"):
        return None
    key = key.replace(".downsample.0.", ".downsample_conv.")
    key = key.replace(".downsample.1.", ".downsample_bn.")
    if key.startswith("layer"):
        stage, block, rest = key.split(".", 2)
        key = f"{stage}_{block}.{rest}"
    return key


def write_synthetic_as_coco(root: str, cfg: dict) -> str:
    """The 16 images ``test.py --synthetic`` evaluates, with their boxes, as
    a COCO-style set (PNG), and a config over it as ``data.test``, for
    ``analyze_results`` to draw on. Returns the config's path."""
    from PIL import Image

    h, w = cfg["img_size"]
    bv = cfg["model"]["box_version"]
    ds = make_synthetic_dataset(n_images=PRETRAINED_VAL_IMAGES,
                                num_classes=cfg["model"]["num_classes"],
                                img_size=(h, w), box_version=bv)
    os.makedirs(os.path.join(root, "images"))
    images, annotations = [], []
    for i in range(len(ds)):
        item = ds[i]
        name = f"{item['img_id']:04d}.png"
        Image.fromarray(item["image"]).save(
            os.path.join(root, "images", name))
        images.append({"id": item["img_id"], "file_name": name,
                       "width": w, "height": h})
        for box, label in zip(item["boxes"], item["labels"]):
            annotations.append({
                "id": len(annotations) + 1, "image_id": item["img_id"],
                "category_id": int(label) + 1,
                "bbox": [float(v) for v in box], "iscrowd": 0})
    ann = os.path.join(root, "test.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c + 1, "name": f"class_{c}"}
                                  for c in range(cfg["model"]
                                                 ["num_classes"])]}, f)
    config = os.path.join(root, "analysis_config.py")
    with open(config, "w") as f:
        f.write(f"_base_ = [{CONFIG!r}]\n"
                f"data = dict(test=dict(ann_file={ann!r}, "
                f"img_prefix={os.path.join(root, 'images') + '/'!r}))\n")
    return config


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _same_numbers(card, cpu, what: str) -> float:
    """Integers equal and floats within ``TOOL_TOLERANCE`` between the two
    devices' outputs (dicts, arrays, numbers); returns the largest float
    difference."""
    if isinstance(card, dict):
        if card.keys() != cpu.keys():
            raise AssertionError(f"{what}: keys {card.keys()} vs {cpu.keys()}")
        return max([_same_numbers(card[k], cpu[k], f"{what}.{k}")
                    for k in card] or [0.0])
    a, b = np.asarray(card), np.asarray(cpu)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.shape} {a.dtype} vs {b.shape} "
                             f"{b.dtype}")
    if a.dtype.kind in "iub":
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: the card's {a} vs the CPU's {b}")
        return 0.0
    nan = np.isnan(a)
    if not np.array_equal(nan, np.isnan(b)):
        raise AssertionError(f"{what}: NaN on one device only")
    diff = float(np.abs(a[~nan] - b[~nan]).max(initial=0.0))
    if not diff <= TOOL_TOLERANCE:
        raise AssertionError(f"{what}: the card and the CPU differ by {diff}")
    return diff


def jittered_ground_truth(arrays: dict, seed: int) -> dict:
    """Raw result arrays whose detections are each image's ground truth,
    centres and sizes jittered by up to 3 degrees, with seeded scores: a
    set the tools match (a detector at random weights finds nothing)."""
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    n = min(arrays["boxes"].shape[1], arrays["gt_boxes"].shape[1])
    boxes = np.zeros_like(arrays["boxes"])
    boxes[:, :n] = arrays["gt_boxes"][:, :n]
    boxes[:, :, :4] += rng.uniform(-3.0, 3.0, boxes[:, :, :4].shape)
    boxes[:, :, 0] = np.mod(boxes[:, :, 0], 360.0)
    boxes[:, :, 2:4] = np.abs(boxes[:, :, 2:4])
    out["boxes"] = boxes.astype(np.float32)
    out["labels"] = np.zeros_like(arrays["labels"])
    out["labels"][:, :n] = arrays["gt_labels"][:, :n]
    out["valid"] = np.zeros_like(arrays["valid"])
    out["valid"][:, :n] = arrays["gt_mask"][:, :n]
    out["scores"] = rng.uniform(0.05, 1.0, arrays["scores"].shape).astype(
        np.float32)
    return out


def run_analysis_tools(tmp: str, raw_npz: str, analysis_cfg: str,
                       num_classes: int) -> dict:
    """The four tools on the raw file, with ``--device cuda`` and again
    with ``--device cpu``: integer outputs equal, floats within
    ``TOOL_TOLERANCE``, each tool's seconds, the figures of the two
    plotting tools written (``visualize/canvas.py``, no matplotlib)."""
    arrays = load_raw_results(raw_npz)
    tmp = os.path.join(tmp, os.path.basename(raw_npz)[:-4])
    out, figures = {}, {}
    for device in ("cuda", "cpu"):
        run = {}
        d = os.path.join(tmp, f"tools_{device}")
        _, run["confusion_matrix_s"] = _timed(lambda: _said(
            lambda: confusion_cli.main([CONFIG, raw_npz, d, "--device",
                                        device])))
        run["confusion_matrix"] = np.load(
            os.path.join(d, "confusion_matrix.npy"))
        _, run["coco_error_analysis_s"] = _timed(lambda: _said(
            lambda: error_cli.main([CONFIG, raw_npz, d, "--device",
                                    device])))
        with open(os.path.join(d, "error_analysis.json")) as f:
            run["coco_error_analysis"] = json.load(f)
        figures[device] = {n: os.path.getsize(os.path.join(d, n))
                           if os.path.exists(os.path.join(d, n)) else 0
                           for n in sorted(os.listdir(d))
                           if n.endswith(".png")}
        if not figures[device].get("confusion_matrix.png") \
                or not figures[device].get("bbox-allclass-allarea.png") \
                or not all(figures[device].values()):
            raise AssertionError(f"figures on {device}: {figures[device]}")
        os.makedirs(tmp, exist_ok=True)
        recall_json = os.path.join(tmp, f"recall_{device}.json")
        _, run["occluded_recall_s"] = _timed(lambda: _said(
            lambda: recall_cli.main([raw_npz, "--device", device, "--out",
                                     recall_json])))
        with open(recall_json) as f:
            run["occluded_recall"] = json.load(f)
        gallery = os.path.join(tmp, f"gallery_{device}")
        _, run["analyze_results_s"] = _timed(lambda: _said(
            lambda: analyze_cli.main([analysis_cfg, raw_npz, gallery,
                                      "--device", device, "--topk", "4"])))
        run["gallery"] = sorted(
            os.path.relpath(os.path.join(r, f), gallery)
            for r, _, fs in os.walk(gallery) for f in fs)
        run["per_image_map"] = per_image_scores(arrays, num_classes,
                                                device=device)
        out[device] = run
    card, cpu = out["cuda"], out["cpu"]
    diffs = {k: _same_numbers(card[k], cpu[k], k) for k in (
        "confusion_matrix", "coco_error_analysis", "occluded_recall",
        "per_image_map")}
    if card["gallery"] != cpu["gallery"] or len(card["gallery"]) != 8:
        raise AssertionError(f"galleries {card['gallery']} vs "
                             f"{cpu['gallery']}")
    from PIL import Image

    for name in card["gallery"]:
        a, b = (np.asarray(Image.open(os.path.join(tmp, f"gallery_{dev}",
                                                   name)))
                for dev in ("cuda", "cpu"))
        if not np.array_equal(a, b):
            raise AssertionError(f"the galleries' {name} differ")
    cm = card["confusion_matrix"]
    return {"seconds": {dev: {k: v for k, v in out[dev].items()
                              if k.endswith("_s")} for dev in out},
            "max_float_diff_card_vs_cpu": diffs,
            "confusion_matrix_on_diagonal": int(np.trace(
                cm[:num_classes, :num_classes])),
            "confusion_matrix_total": int(cm.sum()),
            "occluded_recall": card["occluded_recall"],
            "per_image_map_mean": float(card["per_image_map"].mean()),
            "gallery": card["gallery"], "figures_bytes": figures}


def phase_pretrained(seed: int, reps: int) -> tuple[int, dict]:
    """Pretrained weights and result analysis at full width. (1) A seeded
    torchvision-layout ResNet-50 ``state_dict`` (``fc`` and
    ``num_batches_tracked`` included) written to a ``.pth``; (2) the rotated
    config trains ``PRETRAINED_STEPS`` steps through ``train.main
    --load-backbone``: the first step finds the file's tensors in the
    backbone, the last leaves the frozen stem and stage 1 and every batch
    norm's statistics as the file has them, every loss finite, K1 once a
    step at (256, 98208); (3) ``test.main --synthetic --save-raw``, K1 once
    a val image, the raw file in the JAX package's layout; (4) the four
    analysis tools on it on the card and on the CPU, alike; (5) a seeded
    mmdet RetinaNet-R50 checkpoint through ``convert_reference_checkpoint``
    and ``init_detector``: ``PRETRAINED_REQUESTS`` requests, K1 once each,
    predictions bitwise those of the detector loaded straight from
    ``port_mmdet_retinanet``; (6) the SSD config from a seeded torchvision
    VGG16 ``state_dict``, ``PRETRAINED_SSD_STEPS`` steps: the 13 convs the
    file's, conv6, conv7 and the L2Norm scale their initialisation, K1 once
    a step at (256, 49056) D=4. Returns K1's launches over (2), (3), (5)
    and (6) and its check on the last assignment input of (2)."""
    device = resolve_device()
    torch.backends.cudnn.deterministic = True
    cfg = load_config(CONFIG)
    classes, box_version = cfg["model"]["num_classes"], \
        cfg["model"]["box_version"]
    seconds = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        # (1) the input file
        t0 = time.perf_counter()
        tv = torchvision_resnet50(seed)
        pth = os.path.join(tmp, "resnet50.pth")
        torch.save(tv, pth)
        seconds["write_resnet50_pth"] = time.perf_counter() - t0
        from_file = {torchvision_to_port_name(k): v for k, v in tv.items()
                     if torchvision_to_port_name(k)}

        # (2) train from it; the head's class bias is spread before the
        # first step, so that the evaluation of (3) has detections
        seen = {}
        real_build = train_cli.build_training

        def capturing(*args, **kwargs):
            t0 = time.perf_counter()
            parts = real_build(*args, **kwargs)
            torch.cuda.synchronize()
            seen["build_s"] = time.perf_counter() - t0
            model, optimizer = parts[0], parts[3]
            seen["before"] = {k: v.clone() for k, v in
                              model.backbone.state_dict().items()}
            ema = optimizer.ema_state_dict()
            seen["ema"] = None if ema is None else {
                k: v.clone() for k, v in ema.items()}
            with torch.no_grad():
                bias = model.bbox_head.retina_cls.bias
                bias.copy_(torch.from_numpy(np.random.default_rng(
                    seed).normal(-1.0, 1.0, bias.shape).astype(np.float32)))
            return parts

        work = os.path.join(tmp, "work")
        train_cli.build_training = capturing
        try:
            run = drive_trainer(CONFIG, PRETRAINED_STEPS, TRAIN_BATCH, seed,
                                extra=["--load-backbone", pth], work=work)
        finally:
            train_cli.build_training = real_build
        seconds["train_main"] = run["seconds"]
        seconds["build_and_load"] = seen["build_s"]
        model, det_cfg, _, optimizer, _ = run["parts"]
        assert_full_width_training(run["cfg"], model, det_cfg, optimizer,
                                   device)
        if f"loaded resnet50 backbone from {pth}" not in run["said"]:
            raise AssertionError(f"the trainer said {run['said']!r}")
        before = seen["before"]
        if set(from_file) != set(before):
            raise AssertionError(
                "the file's tensors and the backbone's differ: "
                f"{sorted(set(from_file) ^ set(before))[:6]}")
        for k, v in from_file.items():
            if not torch.equal(before[k].cpu(), v.to(before[k].dtype)):
                raise AssertionError(f"backbone.{k} is not the file's before "
                                     "the first step")
        if seen["ema"] is not None:
            for k, v in from_file.items():
                if f"backbone.{k}" in seen["ema"] and not torch.equal(
                        seen["ema"][f"backbone.{k}"].cpu(), v):
                    raise AssertionError(f"the EMA shadow of backbone.{k} "
                                         "did not start from the file's")
        after = model.backbone.state_dict()
        kept = sorted(k for k in from_file if f"backbone.{k}" in
                      optimizer.frozen_names
                      or k.endswith(("running_mean", "running_var")))
        if not {"conv1.weight", "layer1_2.conv3.weight",
                "layer4_2.bn3.running_var"} <= set(kept) \
                or "layer2_0.conv1.weight" in kept:
            raise AssertionError(f"frozen: {kept[:8]}...")
        for k in kept:
            if not torch.equal(after[k].cpu(), from_file[k]):
                raise AssertionError(f"backbone.{k} moved from the file's")
        stage2_moved = not torch.equal(after["layer2_0.conv1.weight"].cpu(),
                                       from_file["layer2_0.conv1.weight"])
        ema_checked = seen["ema"] is not None
        if run["launches"] != PRETRAINED_STEPS or optimizer.count \
                != PRETRAINED_STEPS:
            raise AssertionError(f"{run['launches']} K1 launches over "
                                 f"{optimizer.count} steps")
        want_call = [list(ASSIGN_SHAPE[::2]), list(ASSIGN_SHAPE[1:])]
        if run["calls"] != [want_call] * PRETRAINED_STEPS:
            raise AssertionError(f"K1 was called at {run['calls']}")
        gt_flat, anchors = run["last_inputs"][ASSIGN_SHAPE[:2]]
        on_input = {"input": "pretrained: the last assignment input of "
                             "training from a loaded backbone",
                    **check_kernel(KERNELS[0], gt_flat, anchors, reps,
                                   identical=False)}
        if not on_input["bitwise_equal"]:
            raise AssertionError(f"K1 differs from its plain version by "
                                 f"{on_input['max_abs_err']}")
        train_losses = [r["loss"] for r in run["steps"]]
        del model, optimizer, run, seen, before, after

        # (3) the raw results
        raw_npz = os.path.join(tmp, "raw.npz")
        nms_calls = []
        nms_module.sph2pob_iou_pairwise = _recording(sph2pob_iou_pairwise,
                                                     nms_calls)
        try:
            sph2pob_iou_pairwise.launches = 0
            said, seconds["test_main"] = _timed(lambda: _said(
                lambda: test_cli.main([CONFIG, os.path.join(work, "ckpts"),
                                       "--synthetic", "--save-raw",
                                       raw_npz])))
            torch.cuda.synchronize()
            test_launches = sph2pob_iou_pairwise.launches
        finally:
            nms_module.sph2pob_iou_pairwise = sph2pob_iou_pairwise
        if test_launches != PRETRAINED_VAL_IMAGES or len(nms_calls) \
                != PRETRAINED_VAL_IMAGES or any(
                    a != b or a[0] > 1000 or a[1] != box_version
                    for a, b in nms_calls):
            raise AssertionError(f"{test_launches} K1 launches, NMS calls "
                                 f"{nms_calls}")
        if f"raw results -> {raw_npz}" not in said:
            raise AssertionError(f"the test CLI said {said!r}")
        arrays = load_raw_results(raw_npz)
        if set(arrays) != RAW_KEYS or {v.shape[0] for v in arrays.values()} \
                != {PRETRAINED_VAL_IMAGES}:
            raise AssertionError(
                f"raw file: { {k: v.shape for k, v in arrays.items()} }")
        detections = int(arrays["valid"].sum())
        if not (arrays["scores"][arrays["valid"]] >= 0.3).any():
            raise AssertionError(f"{detections} detections, none above "
                                 "0.3: the tools would compare nothing")
        raw_bytes = os.path.getsize(raw_npz)
        shutil.rmtree(os.path.join(work, "ckpts"))

        # (4) the analysis tools, on the card and on the CPU
        analysis_cfg, seconds["write_analysis_set"] = _timed(
            lambda: write_synthetic_as_coco(os.path.join(tmp, "coco"), cfg))
        tools = {"test_cli_raw": run_analysis_tools(
            tmp, raw_npz, analysis_cfg, classes)}
        matched_npz = os.path.join(tmp, "ground_truth_jittered.npz")
        save_raw_results(matched_npz, jittered_ground_truth(arrays, seed))
        tools["ground_truth_jittered"] = run_analysis_tools(
            tmp, matched_npz, analysis_cfg, classes)
        if not tools["ground_truth_jittered"]["confusion_matrix_on_diagonal"]:
            raise AssertionError("the jittered ground truth matches nothing")

        # (5) an mmdet checkpoint, converted and served
        sd = mmdet_retinanet_r50(seed + 1, classes, box_version)
        ref = os.path.join(tmp, "ref_epoch_3.pth")
        torch.save({"meta": {"epoch": 3}, "state_dict": sd}, ref)
        said, seconds["convert"] = _timed(lambda: _said(
            lambda: convert_cli.main([ref, os.path.join(tmp, "conv",
                                                        "model.npz"),
                                      "--depth", "50"])))
        (npz,) = os.listdir(os.path.join(tmp, "conv"))
        npz = os.path.join(tmp, "conv", npz)
        if f"converted -> {npz}" not in said:
            raise AssertionError(f"the converter said {said!r}")
        meta = load_published(npz)[2]
        if meta != {"source": "ref_epoch_3.pth", "epoch": 3}:
            raise AssertionError(f"the published meta is {meta}")
        det, seconds["init_detector_from_npz"] = _timed(
            lambda: init_detector(CONFIG, npz))
        assert_full_width(det)
        rng = np.random.default_rng(seed)
        h, w = det.cfg["img_size"]
        images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                  for _ in range(PRETRAINED_REQUESTS)]
        sph2pob_iou_pairwise.launches = 0
        served, seconds["requests"] = _timed(
            lambda: [inference_detector(det, im) for im in images])
        torch.cuda.synchronize()
        convert_launches = sph2pob_iou_pairwise.launches
        if convert_launches != PRETRAINED_REQUESTS:
            raise AssertionError(f"{convert_launches} K1 launches over "
                                 f"{PRETRAINED_REQUESTS} requests")
        direct = init_detector(CONFIG, seed=seed)
        direct.model.load_state_dict(port_mmdet_retinanet(sd, depth=50))
        want = [inference_detector(direct, im) for im in images]
        for got_r, want_r in zip(served, want):
            if len(got_r) != len(want_r) or not all(
                    a.shape == b.shape and np.array_equal(a, b)
                    for a, b in zip(got_r, want_r)):
                raise AssertionError("the converted checkpoint predicts "
                                     "otherwise than port_mmdet_retinanet's")
        served_dets = [int(sum(len(c) for c in r)) for r in served]
        del det, direct, sd

        # (6) SSD from a torchvision VGG16
        vgg = torchvision_vgg16(seed + 2)
        vgg_pth = os.path.join(tmp, "vgg16.pth")
        _, seconds["write_vgg16_pth"] = _timed(lambda: torch.save(vgg,
                                                                 vgg_pth))
        convs = {f"conv{b + 1}_{i + 1}": idx for (b, i), (idx, _, _) in zip(
            [(b, i) for b, (n, _) in enumerate(
                ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)))
             for i in range(n)], VGG16_FEATURES)}
        ssd_seen = {}

        def capturing_ssd(cfg_, *args, **kwargs):
            parts = real_build(cfg_, *args, **kwargs)
            bb = parts[0].backbone
            fresh = get_family(cfg_).build(cfg_)[0]
            fresh.init_weights(torch.Generator().manual_seed(seed))
            ssd_seen["convs_from_file"] = all(
                torch.equal(getattr(bb, name).weight.cpu(),
                            vgg[f"features.{idx}.weight"])
                and torch.equal(getattr(bb, name).bias.cpu(),
                                vgg[f"features.{idx}.bias"])
                for name, idx in convs.items())
            ssd_seen["rest_initialised"] = all(
                torch.equal(a.cpu(), b) for name in ("conv6", "conv7",
                                                     "l2_norm")
                for a, b in zip(getattr(bb, name).state_dict().values(),
                                getattr(fresh.backbone,
                                        name).state_dict().values()))
            return parts

        train_cli.build_training = capturing_ssd
        try:
            ssd = drive_trainer(SSD_CONFIG, PRETRAINED_SSD_STEPS,
                                SSD_TRAIN_BATCH, seed,
                                extra=["--load-backbone", vgg_pth])
        finally:
            train_cli.build_training = real_build
        seconds["ssd_train_main"] = ssd["seconds"]
        assert_full_width_ssd(ssd["cfg"], ssd["parts"][0], ssd["parts"][1])
        if f"loaded vgg16 backbone from {vgg_pth}" not in ssd["said"] \
                or len(convs) != 13 or not ssd_seen["convs_from_file"] \
                or not ssd_seen["rest_initialised"]:
            raise AssertionError(f"the SSD's backbone: {ssd_seen}")
        want_call = [list(SSD_ASSIGN_SHAPE[::2]), list(SSD_ASSIGN_SHAPE[1:])]
        if ssd["launches"] != PRETRAINED_SSD_STEPS or ssd["calls"] \
                != [want_call] * PRETRAINED_SSD_STEPS:
            raise AssertionError(f"{ssd['launches']} K1 launches, calls "
                                 f"{ssd['calls']}")
        ssd_losses = [r["loss"] for r in ssd["steps"]]
        del ssd

    launches = (PRETRAINED_STEPS + test_launches + convert_launches
                + PRETRAINED_SSD_STEPS)
    emit({"phase": "pretrained", "config": os.path.relpath(CONFIG, ROOT),
          "ssd_config": os.path.relpath(SSD_CONFIG, ROOT),
          "seconds": seconds, "train_losses": train_losses,
          "ema_checked": ema_checked, "stage2_moved": stage2_moved,
          "raw_file_bytes": raw_bytes, "val_detections": detections,
          "tools": tools,
          "served_detections": served_dets, "ssd_losses": ssd_losses,
          "kernel_launches": {"train": PRETRAINED_STEPS,
                              "test_save_raw": test_launches,
                              "converted_requests": convert_launches,
                              "ssd_train": PRETRAINED_SSD_STEPS,
                              "whole_phase": launches},
          "kernel_on_assignment_input": on_input})
    return launches, on_input


PARALLEL_STEPS = 4        # (a): 16 images at batch 4, one evaluation of them
PARALLEL_RANK_STEPS = 2   # (b): 8 images, 2 ranks at batch 2 (4 a step)
PARALLEL_RANK_BATCH = 2
PARALLEL_CHILD_S = 240.0  # (b): each rank's deadline
# (b): the two ranks' run on the card and the one-process run on the same 8
# images differ in their parameter update by rounding only (cuDNN picks its
# algorithms by batch size): max|dθ_2 - dθ_1| / max|dθ_1| <=
# PARALLEL_TOLERANCE, which tests/test_torch_parallel_ranks.py holds below
# the gap a local normaliser leaves on the CPU (0.139 there). fp32 with
# TF32 off (with PyTorch's default TF32 convolutions the gap was 5.7e-3),
# and no warm-up factor: at the config's first-step rate (5e-6) the updates
# would sit near the parameters' own rounding.
PARALLEL_TOLERANCE = 1e-2
PARALLEL_OPTIONS = ("bf16=False", "lr_config.warmup_ratio=1.0",
                    "evaluation.interval=1")
PARALLEL_SHAPE = (128, 98208, 5)  # (b): each rank's 2 images x max_gt 64

# K1 recorded in a child process: each call's (N, M, D) by the assigner and
# by the NMS in ``calls``, the assigner's last input (on the host) in
# ``last["input"]``; ``sph2pob_iou_pairwise.launches`` counts its launches.
K1_CHILD_RECORDER = r'''
import torch
from sph_retina_tpu_torch.boxes import nms
from sph_retina_tpu_torch.models import single_stage
from sph_retina_tpu_torch.ops.sph2pob_iou import sph2pob_iou_pairwise
calls, last = {"assign": [], "nms": []}, {}

def recording(site):
    def call(boxes1, boxes2):
        calls[site].append([boxes1.shape[0], boxes2.shape[0], boxes1.shape[1]])
        if site == "assign":
            last["input"] = (boxes1.cpu(), boxes2.cpu())
        return sph2pob_iou_pairwise(boxes1, boxes2)
    return call

single_stage.sph2pob_iou_pairwise = recording("assign")
nms.sph2pob_iou_pairwise = recording("nms")
'''

# One rank of phase (b), run as ``python -c PARALLEL_CHILD ARGV_JSON OUT``:
# the group first (gloo: NCCL refuses two ranks on one card), then
# ``train.main`` takes it as it finds it. Prints one JSON line.
PARALLEL_CHILD = r'''
import hashlib, json, os, sys, time
sys.modules["torch.utils.tensorboard"] = None
''' + K1_CHILD_RECORDER + r'''
from sph_retina_tpu_torch import parallel, train
from sph_retina_tpu_torch.engine import runner, train as engine_train

argv, out, timeout_s = json.loads(sys.argv[1]), sys.argv[2], float(sys.argv[3])
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.allow_tf32 = False
digests, writes, reduce_ms = [], [], []

def timed_reduce(params, real=engine_train.all_reduce_gradients):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    real(params)
    torch.cuda.synchronize()
    reduce_ms.append((time.perf_counter() - t0) * 1e3)

def counting(path, fn, real=runner._write_atomically):
    writes.append(os.path.basename(path))
    return real(path, fn)

def digest(model):
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()

def building(*args, build=train.build_training, **kwargs):
    parts = build(*args, **kwargs)
    model, step = parts[0], parts[4]
    def stepped(batch):
        metrics = step(batch)
        digests.append(digest(model))
        return metrics
    stepped.generator = step.generator
    return (*parts[:4], stepped)

engine_train.all_reduce_gradients = timed_reduce
runner._write_atomically = counting
train.build_training = building
rank, world = parallel.init_distributed(
    "torch", backend="gloo", timeout_s=timeout_s,
    device=argv[argv.index("--device") + 1])
try:
    backend = torch.distributed.get_backend()
    sph2pob_iou_pairwise.launches = 0
    rc = train.main(argv + ["--launcher", "torch"])
    torch.cuda.synchronize()
    launches = sph2pob_iou_pairwise.launches
    parallel.coordination_barrier("done", timeout_s=timeout_s)
finally:
    torch.distributed.destroy_process_group()
torch.save(last["input"], out)
print(json.dumps({"rank": rank, "world": world, "backend": backend, "rc": rc,
                  "launches": launches, "calls": calls, "digests": digests,
                  "writes": writes, "reduce_ms": reduce_ms,
                  "peak_memory_bytes": torch.cuda.max_memory_allocated()}),
      flush=True)
'''


def free_port() -> int:
    """A TCP port on the loopback free just now (bound, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_environment(rank: int, world: int, port: int):
    """torchrun's variables for this process, restored on the way out."""
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(world), "RANK": str(rank),
           "LOCAL_RANK": str(rank)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _records(work: str) -> list:
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _update_gap(got: dict, want: dict, start: dict) -> float:
    """max|dθ_got - dθ_want| / max|dθ_want| over the floating tensors."""
    num = den = 0.0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        dw = w.float() - start[k].float()
        num = max(num, float((got[k].float() - start[k].float() - dw)
                             .abs().max()))
        den = max(den, float(dw.abs().max()))
    return num / den


def _ranks_of_one_card(argv: list, tmp: str, child: str = PARALLEL_CHILD,
                       deadline_s: float = PARALLEL_CHILD_S) -> list:
    """Two ranks running ``child ARGV_JSON OUT TIMEOUT_S`` (phase
    ``parallel`` (b)'s by default; ``OUT`` the rank's K1 input file in
    ``tmp``), as processes of their own on card 0; each logs to a file (a
    pipe nobody reads can block a rank, and its peer with it); both killed
    at the deadline or when one fails. Returns each rank's JSON line and
    its log."""
    port, procs, logs = free_port(), [], []
    try:
        for rank in range(2):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE="2",
                       RANK=str(rank), LOCAL_RANK="0")
            logs.append(os.path.join(tmp, f"rank{rank}.log"))
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", child, json.dumps(argv),
                     os.path.join(tmp, f"k1_input_rank{rank}.pt"),
                     str(deadline_s)],
                    cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + deadline_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
    said = []
    for p, path in zip(procs, logs):
        with open(path) as f:
            said.append(f.read())
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(
            f"the two ranks ended with {[p.returncode for p in procs]} "
            f"(deadline {deadline_s} s):\n"
            + "\n".join(s[-3000:] for s in said))
    return [(json.loads(s.strip().splitlines()[-1]), s) for s in said]


def phase_parallel(seed: int, reps: int) -> tuple[int, list]:
    """Multi-process data parallelism on the rotated config at full width.
    (a) ``train.main --launcher torch`` at world 1 over NCCL, in this
    process with torchrun's variables set: 16 images, 4 steps, one
    evaluation and a checkpoint; its parameters bitwise those of a
    ``--launcher none`` run of the same seed, the evaluation gathered to 16
    images with the ungathered run's metrics, K1 once a step at (256,
    98208) D=5, the checkpoint restored bitwise. (b) two ranks sharing the
    card over gloo, processes of their own: 8 images, 2 steps at batch 2
    (fp32, TF32 off), one evaluation; the ranks' parameters bitwise alike after every
    step, their update within ``PARALLEL_TOLERANCE`` of a one-process run
    at batch 4 over the same images (``max|dθ_2 - dθ_1| / max|dθ_1|``), K1
    once a step a rank at (128, 98208), 8 images after de-duplication, only
    rank 0 writing. The gradient all-reduce is timed in both (synchronised
    host clock). Returns K1's launches and its checks on the two
    assignment inputs."""
    device = resolve_device()
    torch.backends.cudnn.deterministic = True
    t_phase = time.perf_counter()
    seconds, checks = {}, []
    real_reduce = engine_train.all_reduce_gradients
    reduce_ms = []

    def timed_reduce(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(params)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        # (a) world 1 over NCCL against one process without a group
        options = ("evaluation.interval=1",)
        works = {k: os.path.join(tmp, k) for k in ("none", "nccl")}
        none = drive_trainer(CONFIG, PARALLEL_STEPS, TRAIN_BATCH, seed,
                             work=works["none"], options=options)
        seconds["a_launcher_none"] = none["seconds"]
        want = {k: v.detach().clone()
                for k, v in none["parts"][0].state_dict().items()}
        none_launches = none["launches"]
        del none
        engine_train.all_reduce_gradients = timed_reduce
        try:
            with torchrun_environment(0, 1, free_port()):
                nccl = drive_trainer(CONFIG, PARALLEL_STEPS, TRAIN_BATCH,
                                     seed, extra=["--launcher", "torch"],
                                     work=works["nccl"], options=options)
        finally:
            engine_train.all_reduce_gradients = real_reduce
        seconds["a_launcher_torch"] = nccl["seconds"]
        if torch.distributed.is_initialized():
            raise AssertionError("train.main left its process group open")
        on_card = device.type == "cuda"
        said = (f"process 0/1; backend: {'nccl' if on_card else 'gloo'}; "
                f"device: {'cuda' if on_card else 'cpu'};")
        if said not in nccl["said"]:
            raise AssertionError(f"the trainer said {nccl['said']!r}")
        model, det_cfg, _, optimizer, _ = nccl["parts"]
        assert_full_width_training(nccl["cfg"], model, det_cfg, optimizer,
                                   device)
        got = model.state_dict()
        differ = [k for k, v in want.items() if not torch.equal(got[k], v)]
        if differ:
            raise AssertionError(f"--launcher torch at world 1 differs from "
                                 f"--launcher none in {differ[:6]}")
        want_call = [list(ASSIGN_SHAPE[::2]), list(ASSIGN_SHAPE[1:])]
        if nccl["calls"] != [want_call] * PARALLEL_STEPS:
            raise AssertionError(f"K1 was called at {nccl['calls']}")
        if len(reduce_ms) != PARALLEL_STEPS:
            raise AssertionError(f"{len(reduce_ms)} gradient all-reduces "
                                 f"over {PARALLEL_STEPS} steps")
        gt_flat, anchors = nccl["last_inputs"][ASSIGN_SHAPE[:2]]
        checks.append({"input": "parallel (a): the last assignment input "
                                "at world 1 over NCCL",
                       **check_kernel(KERNELS[0], gt_flat, anchors, reps,
                                      identical=False)})
        vals = {k: [r for r in _records(w) if r["prefix"] == "val"]
                for k, w in works.items()}
        if [r["n_images"] for r in vals["nccl"]] != [PARALLEL_STEPS
                                                     * TRAIN_BATCH] or any(
                vals["nccl"][0][k] != vals["none"][0][k]
                for k in ("mAP", "AP50", "AP75", "n_images")):
            raise AssertionError(f"the evaluations: {vals}")
        fresh = get_family(nccl["cfg"]).build(nccl["cfg"])[0].to(device)
        step = runner.load_checkpoint(os.path.join(works["nccl"], "ckpts"),
                                      fresh)
        restored = fresh.state_dict()
        if step != PARALLEL_STEPS or not all(
                torch.equal(restored[k], v) for k, v in got.items()):
            raise AssertionError("the checkpoint does not restore the "
                                 "trained parameters")
        nccl_launches = nccl["launches"]
        a = {"backend": "nccl" if on_card else "gloo",
             "params_bitwise_launcher_none": True,
             "val": vals["nccl"][0], "checkpoint_restored_bitwise": True,
             "allreduce_ms": reduce_ms,
             "kernel_launches": {"launcher_none": none_launches,
                                 "launcher_torch": nccl_launches}}
        del nccl, model, optimizer, fresh, got, want, restored
        torch.cuda.empty_cache()

        # (b) two gloo ranks on the card against one process at batch 4
        rank_images = PARALLEL_RANK_STEPS * PARALLEL_RANK_BATCH * 2
        opts = [f"data.n_synthetic={rank_images}", "log_config.interval=1",
                *PARALLEL_OPTIONS]
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            one = drive_trainer(CONFIG, PARALLEL_RANK_STEPS,
                                rank_images // 2, seed,
                                work=os.path.join(tmp, "one"),
                                options=PARALLEL_OPTIONS)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        seconds["b_one_process"] = one["seconds"]
        cfg = one["cfg"]
        theta1 = {k: v.detach().cpu() for k, v in
                  one["parts"][0].state_dict().items()}
        one_launches = one["launches"]
        del one
        start = get_family(cfg).build(cfg)[0]
        start.init_weights(torch.Generator().manual_seed(seed))
        theta0 = start.state_dict()
        torch.cuda.empty_cache()
        work = os.path.join(tmp, "ranks")
        argv = [CONFIG, "--synthetic", "--seed", str(seed), "--max-epochs",
                "1", "--work-dir", work, "--device", device.type,
                "--cfg-options",
                f"data.samples_per_gpu={PARALLEL_RANK_BATCH}", *opts]
        t0 = time.perf_counter()
        ranks = _ranks_of_one_card(argv, tmp)
        seconds["b_two_ranks"] = time.perf_counter() - t0
        (r0, said0), (r1, said1) = ranks
        if r0["digests"] != r1["digests"] \
                or len(r0["digests"]) != PARALLEL_RANK_STEPS:
            raise AssertionError(f"the ranks' parameters after each step: "
                                 f"{r0['digests']} / {r1['digests']}")
        for r, said in ranks:
            if r["backend"] != "gloo" or r["rc"] != 0 \
                    or f"process {r['rank']}/2; backend: gloo; device: " \
                    f"{'cuda' if on_card else 'cpu'};" not in said:
                raise AssertionError(f"rank {r['rank']} said {said[-2000:]}")
            if r["calls"]["assign"] \
                    != [list(PARALLEL_SHAPE)] * PARALLEL_RANK_STEPS \
                    or r["launches"] != PARALLEL_RANK_STEPS + len(
                        r["calls"]["nms"]):
                raise AssertionError(f"rank {r['rank']}: {r['launches']} "
                                     f"K1 launches, calls {r['calls']}")
        if r1["writes"] or "latest.txt" not in r0["writes"]:
            raise AssertionError(f"writes: {r0['writes']} / {r1['writes']}")
        records = _records(work)
        if [r["step"] for r in records if r["prefix"] == "train"] != list(
                range(1, PARALLEL_RANK_STEPS + 1)) or [
                r["n_images"] for r in records if r["prefix"] == "val"] \
                != [rank_images]:
            raise AssertionError(f"the ranks logged {records}")
        theta2 = runner.read_checkpoint(os.path.join(
            work, "ckpts", "epoch_1"))["model"]
        gap = _update_gap(theta2, theta1, theta0)
        if not gap <= PARALLEL_TOLERANCE:
            raise AssertionError(
                f"two ranks' update is {gap} from one process's (tolerance "
                f"{PARALLEL_TOLERANCE})")
        b1, b2 = torch.load(os.path.join(tmp, "k1_input_rank0.pt"))
        checks.append({"input": "parallel (b): rank 0's last assignment "
                                "input of two gloo ranks on one card",
                       **check_kernel(KERNELS[0], b1.to(device),
                                      b2.to(device), reps, identical=False)})
        for c in checks:
            if not c["bitwise_equal"]:
                raise AssertionError(f"K1 differs from its plain version "
                                     f"on {c['input']}: {c['max_abs_err']}")
        b = {"backend": "gloo", "ranks_bitwise_after_each_step": True,
             "update_gap": gap, "tolerance": PARALLEL_TOLERANCE,
             "val": [r for r in records if r["prefix"] == "val"][0],
             "rank0_writes": r0["writes"],
             "allreduce_ms": {f"rank{r['rank']}": r["reduce_ms"]
                              for r, _ in ranks},
             "peak_memory_bytes": {f"rank{r['rank']}": r["peak_memory_bytes"]
                                   for r, _ in ranks},
             "kernel_launches": {"one_process": one_launches,
                                 **{f"rank{r['rank']}": r["launches"]
                                    for r, _ in ranks}},
             "nms_calls_a_rank": len(r0["calls"]["nms"])}
    launches = (none_launches + nccl_launches + one_launches
                + r0["launches"] + r1["launches"])
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "parallel", "config": os.path.relpath(CONFIG, ROOT),
          "seconds": seconds, "world1_nccl": a, "two_ranks_gloo": b,
          "kernel_launches": launches, "kernel_on_assignment_inputs": checks})
    return launches, checks


ROBUST_VAL_IMAGES = 4       # INPUT_SIZE panoramas: one batch, one K1 an image
ROBUST_SEVERITIES = (0, 3)  # the clean set once, then each corruption at 3
ROBUST_TRAIN_STEPS = 2      # the checkpoint the tools score
ROBUST_GRAIN = 24           # levels of texture on the panoramas (the blurs
                            # change smooth gradients by < 0.5 level)
ROBUST_CLEAN_TOLERANCE = 1e-4  # the tool's clean entry against test.main's


def _metric_gap(got: dict, want: dict, what: str) -> float:
    """The largest difference between two dicts of float metrics with the
    same keys, every value finite."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)}")
    if not all(isinstance(v, float) and math.isfinite(v)
               for v in (*got.values(), *want.values())):
        raise AssertionError(f"{what}: {got} vs {want}")
    return max(abs(got[k] - want[k]) for k in got)


def phase_robustness(seed: int, reps: int) -> tuple[int, dict]:
    """The corruption-robustness benchmark and the offline scoring tools on
    the rotated config at full width, with ``cv2`` made unimportable. On
    ``ROBUST_VAL_IMAGES`` panoramas at ``INPUT_SIZE`` (``write_panoramas``
    with ``ROBUST_GRAIN``):
    (1) each of the 15 corruptions at severity 3 on each image, its host
    ms (median of the images), the same bytes from a second call, a mean
    change of more than 0.5 level; (2) a checkpoint from
    ``ROBUST_TRAIN_STEPS`` steps of ``train.main`` (the class bias spread,
    so that the detector detects); (3) ``test_robustness.main
    --corruptions benchmark --severities 0 3``: 16 evaluations (seconds,
    the loader's images a second, K1 once a val image in each), the JAX
    package's JSON layout with finite metrics, then ``robustness_eval``;
    (4) ``test.main --save-raw``: its metrics within
    ``ROBUST_CLEAN_TOLERANCE`` of the tool's clean entry; (5)
    ``eval_metric.main`` on the raw file within ``TOOL_TOLERANCE`` of
    ``test.main``'s; (6) ``eval_pr_curve.main``, its figure written, K1
    once a val image;
    (7) K1 bitwise its plain version on the last NMS input. Returns K1's
    launches over (2)-(6) and the check of (7)."""
    import importlib.util

    from PIL import Image

    t_phase = time.perf_counter()
    cfg = load_config(CONFIG)
    classes = cfg["model"]["num_classes"]
    cv2_installed = importlib.util.find_spec("cv2") is not None
    seconds = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    saved_cv2 = sys.modules.pop("cv2", None)
    sys.modules["cv2"] = None  # an import of OpenCV fails from here on
    try:
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build")) as tmp:
            ann, img_dir = write_panoramas(tmp, "val", ROBUST_VAL_IMAGES,
                                           classes, seed, ROBUST_GRAIN)
            cfg_path = os.path.join(tmp, "robust_cfg.py")
            with open(cfg_path, "w") as f:
                f.write(f"_base_ = [{CONFIG!r}]\ndata = dict(test=dict("
                        f"ann_file={ann!r}, img_prefix={img_dir!r}))\n")

            # (1) the corruptions on the host, at the panoramas' size
            images = []
            for name in sorted(os.listdir(img_dir)):
                with Image.open(os.path.join(img_dir, name)) as im:
                    images.append(np.asarray(im.convert("RGB")))
            if {im.shape for im in images} != {(*INPUT_SIZE, 3)}:
                raise AssertionError(f"{[im.shape for im in images]}")
            per = {}
            for name in BENCHMARK_CORRUPTIONS:
                ms, outs = [], []
                for i, img in enumerate(images):
                    t0 = time.perf_counter()
                    outs.append(corrupt(img, name, 3, seed=i))
                    ms.append((time.perf_counter() - t0) * 1e3)
                change = float(np.abs(outs[0].astype(np.int16)
                                      - images[0]).mean())
                if outs[0].shape != images[0].shape \
                        or outs[0].dtype != np.uint8 or not change > 0.5:
                    raise AssertionError(f"{name}: {outs[0].shape} "
                                         f"{outs[0].dtype}, {change} levels")
                if not np.array_equal(corrupt(images[0], name, 3, seed=0),
                                      outs[0]):
                    raise AssertionError(f"{name}: two calls, two images")
                per[name] = {"host_ms": statistics.median(ms),
                             "host_ms_each": ms,
                             "mean_change_levels": change}
            seconds["corruptions_on_host"] = sum(
                sum(p["host_ms_each"]) for p in per.values()) / 1e3
            del images

            # (2) the checkpoint
            real_build = train_cli.build_training

            def spreading(*args, **kwargs):
                parts = real_build(*args, **kwargs)
                bias = parts[0].bbox_head.retina_cls.bias
                with torch.no_grad():
                    bias.copy_(torch.from_numpy(np.random.default_rng(
                        seed).normal(-1.0, 1.0, bias.shape).astype(
                            np.float32)))
                return parts

            work = os.path.join(tmp, "work")
            train_cli.build_training = spreading
            try:
                run = drive_trainer(CONFIG, ROBUST_TRAIN_STEPS, TRAIN_BATCH,
                                    seed, work=work)
            finally:
                train_cli.build_training = real_build
            seconds["train_main"] = run["seconds"]
            train_launches = run["launches"]
            if train_launches != ROBUST_TRAIN_STEPS:
                raise AssertionError(f"{train_launches} K1 launches over "
                                     f"{ROBUST_TRAIN_STEPS} steps")
            del run
            ckpts = os.path.join(work, "ckpts")

            # (3) the benchmark
            evals, rates, nms_calls = [], [], []
            real_eval, real_epoch = robust_cli.evaluate_dataset, \
                DataLoader.epoch

            def counted(*args, **kwargs):
                before = sph2pob_iou_pairwise.launches
                t0 = time.perf_counter()
                out = real_eval(*args, **kwargs)
                torch.cuda.synchronize()
                evals.append({"seconds": time.perf_counter() - t0,
                              "launches": sph2pob_iou_pairwise.launches
                              - before, "n_images": out["n_images"]})
                return out

            def timed_epoch(self, epoch=0):
                t0, n, t1 = time.perf_counter(), 0, None
                for batch in real_epoch(self, epoch):
                    n += len(batch["images"])
                    t1 = time.perf_counter()
                    yield batch
                rates.append(n / (t1 - t0))

            robust_json = os.path.join(tmp, "robust.json")
            robust_cli.evaluate_dataset = counted
            DataLoader.epoch = timed_epoch
            nms_module.sph2pob_iou_pairwise = _recording(
                sph2pob_iou_pairwise, nms_calls, keep_last=True)
            try:
                sph2pob_iou_pairwise.launches = 0
                said, seconds["test_robustness"] = _timed(lambda: _said(
                    lambda: robust_cli.main([
                        cfg_path, ckpts, "--corruptions", "benchmark",
                        "--severities", *map(str, ROBUST_SEVERITIES),
                        "--out", robust_json])))
                torch.cuda.synchronize()
                tool_launches = sph2pob_iou_pairwise.launches
            finally:
                robust_cli.evaluate_dataset = real_eval
                DataLoader.epoch = real_epoch
            corrupted = [str(v) for v in ROBUST_SEVERITIES if v]
            n_evals = 1 + len(BENCHMARK_CORRUPTIONS) * len(corrupted)
            if len(evals) != n_evals or len(rates) != n_evals or any(
                    e["launches"] != ROBUST_VAL_IMAGES
                    or e["n_images"] != ROBUST_VAL_IMAGES for e in evals) \
                    or tool_launches != n_evals * ROBUST_VAL_IMAGES:
                raise AssertionError(f"{tool_launches} K1 launches over "
                                     f"the evaluations {evals}")
            with open(robust_json) as f:
                results = json.load(f)
            if list(results) != ["clean", *BENCHMARK_CORRUPTIONS] \
                    or list(results["clean"]) != ["0"] \
                    or any(list(results[n]) != corrupted
                           for n in BENCHMARK_CORRUPTIONS):
                raise AssertionError("the JSON's layout: " + str(
                    {k: list(v) for k, v in results.items()}))
            runs = [("clean", "0")] + [(n, v) for n in BENCHMARK_CORRUPTIONS
                                       for v in corrupted]
            for (name, sev), e, r in zip(runs, evals, rates):
                _metric_gap(results[name][sev], results["clean"]["0"], name)
                per.setdefault(name, {})[f"severity_{sev}"] = {
                    "evaluation_s": e["seconds"], "loader_images_per_s": r}
            summary = summary_cli.get_results(robust_json)
            said_summary = _said(lambda: summary_cli.main([robust_json]))
            if "[P]" not in said_summary:
                raise AssertionError(f"robustness_eval said "
                                     f"{said_summary!r}")

            # (4) test.py --save-raw on the same checkpoint and images
            raw, metrics_json = (os.path.join(tmp, n) for n in
                                 ("raw.npz", "test_metrics.json"))
            sph2pob_iou_pairwise.launches = 0
            _, seconds["test_main"] = _timed(lambda: _said(
                lambda: test_cli.main([cfg_path, ckpts, "--save-raw", raw,
                                       "--out", metrics_json])))
            torch.cuda.synchronize()
            test_launches = sph2pob_iou_pairwise.launches
            with open(metrics_json) as f:
                test_metrics = json.load(f)
            clean_gap = _metric_gap(results["clean"]["0"], test_metrics,
                                    "clean vs test.main")
            if test_launches != ROBUST_VAL_IMAGES \
                    or not clean_gap <= ROBUST_CLEAN_TOLERANCE:
                raise AssertionError(f"test.main: {test_launches} K1 "
                                     f"launches, clean gap {clean_gap}")

            # (5) eval_metric on the raw file
            rescored_json = os.path.join(tmp, "rescored.json")
            _, seconds["eval_metric"] = _timed(lambda: _said(
                lambda: metric_cli.main([cfg_path, raw, "--out",
                                         rescored_json])))
            with open(rescored_json) as f:
                rescored = json.load(f)
            rescore_gap = _metric_gap(rescored, test_metrics,
                                      "eval_metric vs test.main")
            if not rescore_gap <= TOOL_TOLERANCE:
                raise AssertionError(f"eval_metric is {rescore_gap} from "
                                     "test.main")

            # (6) eval_pr_curve
            png = os.path.join(tmp, "pr.png")
            sph2pob_iou_pairwise.launches = 0
            said_pr, seconds["eval_pr_curve"] = _timed(lambda: _said(
                lambda: pr_cli.main([cfg_path, ckpts, "--out", png])))
            torch.cuda.synchronize()
            pr_launches = sph2pob_iou_pairwise.launches
            n_curves = said_pr.count("AP=")
            pr_figure_bytes = os.path.getsize(png) \
                if os.path.exists(png) else 0
            if pr_launches != ROBUST_VAL_IMAGES \
                    or f"saved {png}" not in said_pr or not pr_figure_bytes:
                raise AssertionError(f"eval_pr_curve: {pr_launches} K1 "
                                     f"launches, said {said_pr!r}")
    finally:
        nms_module.sph2pob_iou_pairwise = sph2pob_iou_pairwise
        del sys.modules["cv2"]
        if saved_cv2 is not None:
            sys.modules["cv2"] = saved_cv2

    # (7) K1 on the last NMS input
    (shapes, b1, b2), = nms_calls
    on_input = {"input": "robustness: the last NMS input of eval_pr_curve",
                **check_kernel(KERNELS[0], b1, b2, reps, identical=False)}
    if not on_input["bitwise_equal"] or shapes[1][1] != 5:
        raise AssertionError(f"K1 at {shapes} differs from its plain "
                             f"version by {on_input['max_abs_err']}")
    rates = {(n, k): v["loader_images_per_s"] for n in BENCHMARK_CORRUPTIONS
             for k, v in per[n].items() if k.startswith("severity_")}
    slowest = min(rates, key=rates.get)
    launches = train_launches + tool_launches + test_launches + pr_launches
    emit({"phase": "robustness", "config": os.path.relpath(CONFIG, ROOT),
          "input_size": list(INPUT_SIZE), "val_images": ROBUST_VAL_IMAGES,
          "severities": list(ROBUST_SEVERITIES),
          "cv2_installed": cv2_installed, "cv2_importable_in_phase": False,
          "per_corruption": per,
          "loader_images_per_s": {
              "clean": per["clean"]["severity_0"]["loader_images_per_s"],
              "slowest_corruption": "/".join(slowest),
              "slowest": rates[slowest]},
          "summary": summary, "clean_vs_test_main": clean_gap,
          "eval_metric_vs_test_main": rescore_gap,
          "test_main_metrics": test_metrics, "pr_curves": n_curves,
          "pr_figure_bytes": pr_figure_bytes,
          "kernel_launches": {"train": train_launches,
                              "test_robustness": tool_launches,
                              "test_save_raw": test_launches,
                              "eval_pr_curve": pr_launches,
                              "whole_phase": launches},
          "kernel_on_nms_input": on_input, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches, on_input

VIS_TRAIN_STEPS = 2         # the trainer run whose log analyze_logs reads
VIS_PANORAMAS = 3           # INPUT_SIZE panoramas; the first, a PNG, the demo's
CAMERA = (1920, 960, 640)   # erp_w, erp_h, long_side: a view of a panorama
CAMERA_VIEWS = ((100.0, 80.0), (355.0, 40.0), (180.0, 5.0))
ANCHOR_TOLERANCE = 1e-3     # degrees: k-means on the card against the CPU
SCATTER_PAIRS = 10_000


def _score(said: str, what: str) -> float:
    """The number after the last '=' of the line of ``said`` starting with
    ``what``."""
    line = next(x for x in said.splitlines() if x.startswith(what))
    return float(line.rsplit("=", 1)[1])


def _timing(parts: dict, name: str, fn):
    """``fn`` that adds its seconds (the card synchronised) to
    ``parts[name]``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return out
    return wrapper


def phase_visualize(seed: int, reps: int) -> tuple[int, dict]:
    """Drawing, demos and anchor optimisation on the rotated config at full
    width, on ``VIS_PANORAMAS`` panoramas at ``INPUT_SIZE`` it writes:
    (a) ``train.main``, ``VIS_TRAIN_STEPS`` steps (its log for (d)); a
    checkpoint of seeded weights with the head calibrated on the PNG
    panorama, written by ``Checkpointer``; ``image_demo.main`` on it (load,
    read, predict, draw and save timed apart): a detection drawn, K1 once,
    the PNG bitwise ``show_result(det, img, inference_detector(det, img))``
    (K1 once more), K1 bitwise its plain version on the demo's NMS input;
    (b) ``PerspectiveCamera(1920, 960, long_side=640).extract`` on the card
    and on the CPU, the views within 1 level, ms each; (c)
    ``optimize_anchors.main --synthetic``: k-means (25 sweeps) on the card
    and on the CPU, the anchors within ``ANCHOR_TOLERANCE``; differential
    evolution (200 generations, population 48, K = 45) on the card, its
    score at least the config anchors', seconds and peak memory; (d)
    ``vis_kent.main`` (``--mle``, samples, the panorama behind),
    ``plot_iou_scatter`` / ``plot_curve`` on seeded IoUs,
    ``analyze_logs.main`` on (a)'s log, ``create_result_gif.main`` over the
    demo's PNGs, ``browse_dataset.main`` with and without the pipeline:
    every file written, and neither matplotlib nor imageio imported. Returns
    K1's launches over (a) and its check on the demo's NMS input."""
    from PIL import Image

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    cfg = load_config(CONFIG)
    classes = cfg["model"]["num_classes"]
    seconds, files = {}, {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        ann, img_dir = write_panoramas(tmp, "val", VIS_PANORAMAS, classes,
                                       seed)
        png = os.path.join(img_dir, "val_0001.png")

        # (a) the trainer's log, the checkpoint and the demo
        work = os.path.join(tmp, "work")
        run = drive_trainer(CONFIG, VIS_TRAIN_STEPS, TRAIN_BATCH, seed,
                            work=work)
        train_launches, seconds["train_main"] = run["launches"], \
            run["seconds"]
        del run
        if train_launches != VIS_TRAIN_STEPS:
            raise AssertionError(f"{train_launches} K1 launches over "
                                 f"{VIS_TRAIN_STEPS} steps")
        t0 = time.perf_counter()
        det = init_detector(CONFIG, seed=seed)
        det.model.load_state_dict(seeded_state_dict(det.model, seed))
        panorama = det.pipeline.load_image(png)
        head_std = calibrate_head(det, det.pipeline.resize(panorama))
        ckpts = os.path.join(tmp, "ckpts")
        runner.Checkpointer(ckpts).save(
            det.model, build_tx(cfg, det.model, steps_per_epoch=1), epoch=1)
        seconds["write_checkpoint"] = time.perf_counter() - t0
        del det
        demo_dir = os.path.join(tmp, "demo")
        os.makedirs(demo_dir)
        demo_png = os.path.join(demo_dir, "demo.png")
        parts, nms_calls = {}, []
        real = (demo_cli.init_detector, SphPipeline.load_image,
                demo_cli.inference_detector, apis.draw_boxes,
                Image.Image.save)
        (demo_cli.init_detector, SphPipeline.load_image,
         demo_cli.inference_detector, apis.draw_boxes, Image.Image.save) = (
            _timing(parts, name, fn) for name, fn in zip(
                ("load", "read", "predict", "draw", "save"), real))
        nms_module.sph2pob_iou_pairwise = _recording(
            sph2pob_iou_pairwise, nms_calls, keep_last=True)
        try:
            sph2pob_iou_pairwise.launches = 0
            said, seconds["image_demo"] = _timed(lambda: _said(
                lambda: demo_cli.main([png, CONFIG, ckpts, "--out",
                                       demo_png])))
            torch.cuda.synchronize()
            demo_launches = sph2pob_iou_pairwise.launches
        finally:
            (demo_cli.init_detector, SphPipeline.load_image,
             demo_cli.inference_detector, apis.draw_boxes,
             Image.Image.save) = real
            nms_module.sph2pob_iou_pairwise = sph2pob_iou_pairwise
        n_demo = int(said.split(" with ")[1].split()[0])
        det = init_detector(CONFIG, ckpts)
        before = sph2pob_iou_pairwise.launches
        result = inference_detector(det, png)
        torch.cuda.synchronize()
        api_launches = sph2pob_iou_pairwise.launches - before
        shown = show_result(det, png, result,
                            out_file=os.path.join(demo_dir, "shown.png"))
        drawn = sum(int((r[:, -1] >= 0.3).sum()) for r in result)
        same_png = bool(np.array_equal(np.asarray(Image.open(demo_png)),
                                       shown))
        if demo_launches != 1 or api_launches != 1 or drawn < 1 \
                or n_demo != sum(len(r) for r in result) or not same_png:
            raise AssertionError(
                f"image_demo: {demo_launches} K1 launches, {n_demo} "
                f"detections; the API: {api_launches} launches, {drawn} "
                f"drawn, the same PNG: {same_png}")
        (shapes, b1, b2), = nms_calls
        on_input = {"input": "visualize: the NMS input of image_demo",
                    **check_kernel(KERNELS[0], b1, b2, reps,
                                   identical=False)}
        if not on_input["bitwise_equal"] or shapes[1][1] != 5:
            raise AssertionError(f"K1 at {shapes} differs from its plain "
                                 f"version by {on_input['max_abs_err']}")
        demo = {"detections": n_demo, "drawn_at_score_thr": drawn,
                "png_equals_show_result": same_png,
                "head_std_before_calibration": head_std,
                "seconds": seconds["image_demo"], "parts_s": parts,
                "kernel_launches": {"image_demo": demo_launches,
                                    "inference_detector": api_launches}}
        del det, b1, b2, nms_calls

        # (b) the camera, on the card and on the CPU
        erp_w, erp_h, long_side = CAMERA
        on_card = PerspectiveCamera(erp_w, erp_h, long_side=long_side)
        on_cpu = PerspectiveCamera(erp_w, erp_h, long_side=long_side,
                                   device="cpu")
        camera, level_gap = {"card_ms": [], "cpu_ms": []}, 0
        for view in CAMERA_VIEWS:
            a, card_s = _timed(lambda: on_card.extract(panorama, *view))
            b, cpu_s = _timed(lambda: on_cpu.extract(panorama, *view))
            if a.shape != (on_card.img_h, on_card.img_w, 3) \
                    or a.dtype != np.uint8:
                raise AssertionError(f"a view {a.shape} {a.dtype}")
            level_gap = max(level_gap, int(np.abs(a.astype(np.int16)
                                                  - b).max()))
            camera["card_ms"].append(card_s * 1e3)
            camera["cpu_ms"].append(cpu_s * 1e3)
        if level_gap > 1:
            raise AssertionError(f"the card's views are {level_gap} levels "
                                 "from the CPU's")
        resident = torch.from_numpy(panorama).to(on_card.device)
        camera.update({
            "view": [on_card.img_h, on_card.img_w], "max_level_gap":
            level_gap, "resident_card_ms": median_ms(
                lambda: on_card.extract(resident, *CAMERA_VIEWS[0]), reps)})
        del resident

        # (c) the anchor optimiser
        anchors = {}
        for dev in ("cuda", "cpu"):
            out_dir = os.path.join(tmp, f"anchors_{dev}")
            said, t = _timed(lambda: _said(lambda: anchors_cli.main([
                CONFIG, "--synthetic", "--algorithm", "k-means",
                "--device", dev, "--output-dir", out_dir])))
            with open(os.path.join(out_dir,
                                   "anchor_optimize_result.json")) as f:
                found = json.load(f)
            anchors[dev] = {"seconds": t, "gt_boxes": int(said.split()[0]),
                            "before": _score(said, "config anchors"),
                            "after": found["avg_best_iou"],
                            "fovs": np.asarray(
                                found["anchors_alpha_beta_deg"])}
        anchor_gap = float(np.abs(anchors["cuda"].pop("fovs")
                                  - anchors["cpu"].pop("fovs")).max())
        if not anchor_gap <= ANCHOR_TOLERANCE:
            raise AssertionError(f"k-means: the card's anchors are "
                                 f"{anchor_gap} degrees from the CPU's")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        said, seconds["differential_evolution"] = _timed(lambda: _said(
            lambda: anchors_cli.main([CONFIG, "--synthetic"])))
        de = {"seconds": seconds["differential_evolution"],
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "before": _score(said, "config anchors"),
              "after": _score(said, "optimized anchors"),
              "k": int(said.split("K=")[2].split()[0])}
        if de["after"] < de["before"]:
            raise AssertionError(f"differential evolution: {de}")

        # (d) the other tools
        kent_png = os.path.join(tmp, "kent.png")
        said, seconds["vis_kent"] = _timed(lambda: _said(
            lambda: kent_cli.main(["--bfov", "120", "60", "40", "30",
                                   "--mle", "--samples", "500", "--image",
                                   png, "--out", kent_png])))
        rng = np.random.default_rng(seed)
        pairs = [torch.from_numpy(seeded_boxes(SCATTER_PAIRS, 4, rng)).cuda()
                 for _ in range(2)]
        iou = {b: sph_overlaps(*pairs, b, is_aligned=True)
               for b in ("sph2pob_efficient", "unbiased")}
        scatter_png = os.path.join(tmp, "scatter.png")
        r, seconds["plot_iou_scatter"] = _timed(lambda: plot_iou_scatter(
            iou["sph2pob_efficient"], iou["unbiased"], "sph2pob_efficient",
            "unbiased", out_file=scatter_png))
        curve_png = os.path.join(tmp, "curve.png")
        order = torch.argsort(iou["unbiased"]).cpu()
        _, seconds["plot_curve"] = _timed(lambda: plot_curve(
            np.arange(SCATTER_PAIRS), {b: v.cpu()[order]
                                       for b, v in iou.items()},
            "pair, by the oracle's IoU", "IoU", out_file=curve_png))
        log = os.path.join(work, "metrics.jsonl")
        logs_png = os.path.join(tmp, "logs.png")
        said_logs, seconds["analyze_logs"] = _timed(lambda: _said(
            lambda: logs_cli.main(["plot_curve", log, "--keys", "loss",
                                   "loss_cls", "loss_bbox", "--out",
                                   logs_png])) + _said(
            lambda: logs_cli.main(["cal_train_time", log])))
        # the GIF pages through the demo's PNG, the panorama undrawn and
        # show_result's PNG (two equal frames in a row would merge into one)
        Image.fromarray(apis._prepare(
            init_detector(CONFIG, ckpts), panorama)).save(
            os.path.join(demo_dir, "resized.png"))
        gif = os.path.join(tmp, "demo.gif")
        said_gif, seconds["create_result_gif"] = _timed(lambda: _said(
            lambda: gif_cli.main([demo_dir, "--out", gif])))
        browse_cfg = os.path.join(tmp, "browse_cfg.py")
        with open(browse_cfg, "w") as f:
            f.write(f"_base_ = [{CONFIG!r}]\ndata = dict(train=dict("
                    f"ann_file={ann!r}, img_prefix={img_dir!r}))\n")
        browsed = {}
        for name, extra in (("pipeline", []), ("raw", ["--no-pipeline"])):
            out_dir = os.path.join(tmp, f"browse_{name}")
            _, seconds[f"browse_dataset_{name}"] = _timed(lambda: _said(
                lambda: browse_cli.main([browse_cfg, "--out-dir", out_dir,
                                         *extra])))
            browsed[name] = sorted(os.listdir(out_dir))
            for f in browsed[name]:
                files[f"browse_{name}/{f}"] = os.path.getsize(
                    os.path.join(out_dir, f))
        for path in (demo_png, kent_png, scatter_png, curve_png, logs_png,
                     gif):
            files[os.path.basename(path)] = os.path.getsize(path) \
                if os.path.exists(path) else 0
        with Image.open(gif) as im:
            gif_frames = im.n_frames
        if not all(files.values()) or gif_frames != 3 \
                or not said_logs.startswith(f"saved {logs_png}") \
                or "epochs: 1" not in said_logs \
                or any(len(v) != VIS_PANORAMAS for v in browsed.values()):
            raise AssertionError(f"files {files}, {gif_frames} GIF frames, "
                                 f"analyze_logs said {said_logs!r}")
    leaked = [m for m in ("matplotlib", "imageio") if m in sys.modules]
    if leaked:
        raise AssertionError(f"imported: {leaked}")
    launches = train_launches + demo_launches + api_launches
    emit({"phase": "visualize", "config": os.path.relpath(CONFIG, ROOT),
          "input_size": list(INPUT_SIZE), "demo": demo, "camera": camera,
          "anchors_kmeans": anchors, "anchors_kmeans_gap_deg": anchor_gap,
          "anchors_differential_evolution": de, "iou_scatter_r": float(r),
          "files_bytes": files, "gif_frames": gif_frames,
          "matplotlib_or_imageio_imported": leaked,
          "kernel_launches": {"train": train_launches,
                              "image_demo": demo_launches,
                              "show_result_predict": api_launches,
                              "whole_phase": launches},
          "kernel_on_nms_input": on_input, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches, on_input


MEASURE_FPS_WARMUP = 5
MEASURE_FPS_ITERS = 20
MEASURE_FPS_BATCHES = (1, 8)
MEASURE_BATCH = 4             # profile_step's default batch
MEASURE_TRACE_STEPS = 2
BREAKDOWN_ITERS = 15          # profile_step.report_breakdown's loop length
PARAMS_R50_ROTATED = 37_304_852
FLOPS_RANGE = (0.21e12, 0.23e12)  # 512x1024: ~16x the 128x256 count
FLOPS_SMALL_SHAPE = (128, 256)    # card vs CPU, where the CPU is quick
REMAT_LOSS_TOLERANCE = 1e-3   # relative: the same forward kernels either way
MFU_TIMEOUT_S = 600
HOST_ARGS = ["--img-size", "512", "1024", "--n-images", "16",
             "--workers", "1", "2", "4", "--probe-link"]


def _kernel_events(trace_path: str) -> dict:
    """CUDA kernel events of a Chrome trace, in all and K1's."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"kernel_events": len(kernels),
            "k1_events": sum(KERNELS[0].device_name in e.get("name", "")
                             for e in kernels)}


def _counted(fn, calls: list) -> tuple[str, int]:
    """``fn``'s output and the pairwise kernel's launches during it, the
    kernel's calls recorded in ``calls`` (the last call's inputs kept)."""
    real = (single_stage.sph2pob_iou_pairwise,
            nms_module.sph2pob_iou_pairwise)
    single_stage.sph2pob_iou_pairwise = nms_module.sph2pob_iou_pairwise = \
        _recording(sph2pob_iou_pairwise, calls, keep_last=True)
    try:
        sph2pob_iou_pairwise.launches = 0
        said = _said(fn)
        torch.cuda.synchronize()
        return said, sph2pob_iou_pairwise.launches
    finally:
        single_stage.sph2pob_iou_pairwise, \
            nms_module.sph2pob_iou_pairwise = real


def _on_input(calls: list, what: str, shape, reps: int) -> dict:
    """K1 against its plain version on the last recorded input, which must
    have ``shape`` (None: any)."""
    (shapes, b1, b2), = calls
    got = [shapes[0][0], shapes[1][0], shapes[0][1]]
    if shape is not None and got != list(shape):
        raise AssertionError(f"{what}: K1 at {got}, expected {list(shape)}")
    res = {"input": what, **check_kernel(KERNELS[0], b1, b2, reps,
                                         identical=False)}
    if not res["bitwise_equal"]:
        raise AssertionError(f"{what}: K1 differs from its plain version "
                             f"by {res['max_abs_err']}")
    return res


def phase_measure(seed: int, reps: int) -> tuple[int, list]:
    """The measurement tools on the rotated config at full width (or the
    config a tool fixes), each through its ``main(argv)`` in this process
    but ``mfu_experiment``'s child: ``print_config`` (the text's sha256);
    ``get_flops`` at 512x1024 (the parameters, the FLOPs in range, the
    count on the card equal to the count on the meta device and, at
    128x256, on the CPU); ``benchmark_fps`` at batch 1 and 8 with and
    without ``--with-nms`` (images a second, K1 once an image a call,
    bitwise at the last NMS input); ``profile_step`` at batch 4: the trace
    (bytes, kernel events, K1's), ``--breakdown``, ``--memory`` (remat
    lowers the peak; the step's loss the same within
    ``REMAT_LOSS_TOLERANCE``), K1 bitwise at the assignment input (64,
    98208) D=5; ``mfu_experiment --experiments baseline`` (step ms, images
    a second, 0 < mfu <= 1.05, the card's name and power limit; K1 bitwise
    at the child's assignment input (128, 98208) D=4, which it saves);
    ``bench_host_pipeline`` at 512x1024, 16 images, workers 1 2 4 with the
    link probe. cuDNN runs in its default, non-deterministic mode, as a
    user's. Returns K1's launches in this process and its checks."""
    t_phase = time.perf_counter()
    device = resolve_device()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    seconds, launches, on_inputs = {}, {}, []
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "build")) as tmp:
            # print_config
            text, seconds["print_config"] = _timed(
                lambda: _said(lambda: config_cli.main([CONFIG])))
            printed = {"sha256": hashlib.sha256(text.encode()).hexdigest(),
                       "lines": len(text.splitlines())}
            if "'num_classes': 47" not in text:
                raise AssertionError(f"print_config said {text[:200]!r}")

            # get_flops
            said, seconds["get_flops"] = _timed(
                lambda: _said(lambda: flops_cli.main([CONFIG])))
            params = int(said.split("params:")[1].split("(")[1].split(")")[0])
            cfg = load_config(CONFIG)
            h, w = cfg["img_size"]

            def count_on(where, shape):
                c = dict(cfg, img_size=shape)
                with torch.device(where):
                    model, _ = get_family(c).build(c)
                with torch.no_grad():
                    return flops_cli.count_flops(
                        model.eval(), torch.zeros((1, *shape, 3),
                                                  device=where))

            # the FLOPs depend on shapes only; the bytes on layouts too
            card, meta = count_on(device, (h, w)), count_on("meta", (h, w))
            small = {d: count_on(d, FLOPS_SMALL_SHAPE)
                     for d in (device, "cpu")}
            flops = {"params": params, "flops": card.total,
                     "flops_by_class": dict(card.flops), "bytes": card.bytes,
                     "printed": said.splitlines()[3:5],
                     "equal_on_meta": card.flops == meta.flops,
                     f"flops_{FLOPS_SMALL_SHAPE[0]}x{FLOPS_SMALL_SHAPE[1]}":
                     small[device].total,
                     "small_equal_on_cpu": (small[device].flops,
                                            small[device].bytes)
                     == (small["cpu"].flops, small["cpu"].bytes)}
            if params != PARAMS_R50_ROTATED or not flops["equal_on_meta"] \
                    or not flops["small_equal_on_cpu"] \
                    or not FLOPS_RANGE[0] <= card.total <= FLOPS_RANGE[1]:
                raise AssertionError(f"get_flops: {flops}")

            # benchmark_fps
            fps = []
            for b in MEASURE_FPS_BATCHES:
                for nms in (False, True):
                    calls = []
                    argv = [CONFIG, "--batch-size", str(b), "--warmup",
                            str(MEASURE_FPS_WARMUP), "--max-iter",
                            str(MEASURE_FPS_ITERS)] + (["--with-nms"]
                                                       if nms else [])
                    (said, n), s = _timed(lambda: _counted(
                        lambda: fps_cli.main(argv), calls))
                    rec = json.loads(said.splitlines()[-1])
                    want = b * (MEASURE_FPS_WARMUP + MEASURE_FPS_ITERS) \
                        if nms else 0
                    if n != want or rec["device"] != \
                            torch.cuda.get_device_name(0):
                        raise AssertionError(
                            f"benchmark_fps {argv}: {n} K1 launches "
                            f"(expected {want}): {rec}")
                    fps.append({**rec, "k1_launches": n, "seconds": s})
                    launches[f"benchmark_fps_b{b}_nms{int(nms)}"] = n
            on_inputs.append(_on_input(
                calls, "measure: the last NMS input of benchmark_fps "
                "--with-nms", None, reps))

            # profile_step: the trace, the breakdown, the memory
            base = [CONFIG, "--batch-size", str(MEASURE_BATCH)]
            calls = []
            logdir = os.path.join(tmp, "trace")
            (said, n), seconds["profile_step_trace"] = _timed(
                lambda: _counted(lambda: profile_cli.main(
                    base + ["--steps", str(MEASURE_TRACE_STEPS), "--logdir",
                            logdir]), calls))
            path = os.path.join(logdir, "train_step.json")
            trace = {"bytes": os.path.getsize(path), **_kernel_events(path),
                     "k1_launches": n}
            if n != 1 + MEASURE_TRACE_STEPS or trace["kernel_events"] < 1:
                raise AssertionError(f"profile_step trace: {trace}")
            launches["profile_step_trace"] = n
            on_inputs.append(_on_input(
                calls, "measure: the assignment input of profile_step",
                PROFILE_ASSIGN_SHAPE, reps))

            (said, n), seconds["profile_step_breakdown"] = _timed(
                lambda: _counted(lambda: profile_cli.main(
                    base + ["--breakdown"]), []))
            rows = {line[2:46].rstrip(): float(line[46:].split("ms")[0])
                    for line in said.splitlines()[1:]}
            want = 2 * (1 + 2 * BREAKDOWN_ITERS)  # the loss and the step
            if n != want or len(rows) != 6:
                raise AssertionError(f"breakdown: {n} K1 launches "
                                     f"(expected {want}): {said!r}")
            launches["profile_step_breakdown"] = n
            breakdown = {"rows_ms": rows, "header": said.splitlines()[0],
                         "last_line": said.splitlines()[-1].strip()}

            (said, n), seconds["profile_step_memory"] = _timed(
                lambda: _counted(lambda: profile_cli.main(
                    base + ["--memory"]), []))
            mem = {}
            for line in said.splitlines():
                if line.startswith("remat="):
                    key = line.split(":")[0]
                    mem[key] = {
                        k: float(line.split(f"{k}=")[1].split()[0])
                        for k in ("temp", "args", "out")}
                    mem[key]["loss"] = float(
                        line.split("(loss ")[1].rstrip(")"))
            mem["summary"] = said.splitlines()[-1]
            off, on = mem["remat=False"], mem["remat=True"]
            mem["loss_rel_gap"] = abs(on["loss"] - off["loss"]) \
                / abs(off["loss"])
            if n != 3 or not on["temp"] < off["temp"] \
                    or not mem["loss_rel_gap"] <= REMAT_LOSS_TOLERANCE:
                raise AssertionError(f"--memory: {n} K1 launches, {mem}")
            launches["profile_step_memory"] = n

            # mfu_experiment: its child is a process of its own
            out_json = os.path.join(tmp, "mfu.json")
            saved = os.path.join(tmp, "mfu_iou_input.pt")
            said, seconds["mfu_experiment"] = _timed(lambda: _said(
                lambda: mfu_cli.main([
                    "--out", out_json, "--experiments", "baseline",
                    "--timeout", str(MFU_TIMEOUT_S),
                    "--save-iou-input", saved])))
            with open(out_json) as f:
                mfu = json.load(f)["baseline"]
            if not 0.0 < mfu.get("mfu", -1.0) <= 1.05:
                raise AssertionError(f"mfu_experiment: {mfu}")
            b1, b2 = (t.to(device) for t in torch.load(saved))
            on_inputs.append(_on_input(
                [([list(b1.shape), list(b2.shape)], b1, b2)],
                "measure: the assignment input of mfu_experiment's child",
                MFU_ASSIGN_SHAPE, reps))
            del b1, b2

            # bench_host_pipeline, its JPEG cache under the phase's TMPDIR
            out_json = os.path.join(tmp, "host.json")
            saved_tmpdir = os.environ.get("TMPDIR")
            os.environ["TMPDIR"] = tmp
            try:
                said, seconds["bench_host_pipeline"] = _timed(
                    lambda: _said(lambda: host_cli.main(
                        HOST_ARGS + ["--out", out_json])))
            finally:
                if saved_tmpdir is None:
                    del os.environ["TMPDIR"]
                else:
                    os.environ["TMPDIR"] = saved_tmpdir
            with open(out_json) as f:
                host = json.load(f)
            rates = host["loader_imgs_per_sec"]
            if not all(v > 0 for cs in ("rgb", "yuv420")
                       for v in rates[cs].values()) \
                    or host["stages_single_thread"]["pil_decode_ms"] <= 0:
                raise AssertionError(f"bench_host_pipeline: {host}")
            host["native_decoder"] = {
                k: v for k, v in native_loader.status().items()
                if k != "reason"}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    total = sum(launches.values())
    emit({"phase": "measure", "config": os.path.relpath(CONFIG, ROOT),
          "print_config": printed, "get_flops": flops,
          "benchmark_fps": fps, "profile_step": {
              "batch": MEASURE_BATCH, "trace": trace,
              "breakdown": breakdown, "memory": mem},
          "mfu_experiment": mfu, "bench_host_pipeline": host,
          "kernel_launches": {**launches, "whole_phase": total},
          "kernel_on_inputs": on_inputs, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase})
    return total, on_inputs


# --------------------------------------------------------------------------- #
# phase study: the sphere-bench study tools, the converters, the launchers
# --------------------------------------------------------------------------- #
SPHERE_BENCH = os.path.join(ROOT, "work_dirs", "sphere_bench")
SPHERE_BENCH_ANNOTATIONS = tuple(
    os.path.join(SPHERE_BENCH, "annotations", f"instances_{s}.json")
    for s in ("train", "val"))
PUBLISHED_AUDIT = os.path.join(ROOT, "work_dirs", "assign_audit",
                               "audit.json")
PUBLISHED_STUDY = os.path.join(ROOT, "work_dirs", "ap_study", "report.json")
AUDIT_BACKENDS = ("sph2pob_efficient", "sph2pob_efficient_jnp", "sph", "fov",
                  "unbiased")
AUDIT_SHAPE = (88, 24552, 4)   # batch 8 x the train split's 11 GTs at most
AUDIT_BATCHES = 63             # 500 images at batch 8, the last one padded
AUDIT_DENSITY_TOLERANCE = 0.01   # relative, positives a GT
AUDIT_FLIP_TOLERANCE = 1e-3      # the category flip rate
QUICK_SHAPE = (192, 6138, 4)   # batch 8 x max_gt 24 against the 128x256 grid
QUICK_STEPS = 6                # 2 epochs of 24 images at batch 8
QUICK_K1_VARIANTS = ("l1", "ciou")   # their assigner is sph2pob_efficient
LAUNCH_IMAGES = 8              # dist_train.sh: 2 steps at batch 4
LAUNCH_TEST_IMAGES = 16        # test.py --synthetic's set
LAUNCH_TIMEOUT_S = 300
STUDY_VARIANTS = ("l1", "ciou")      # --study: 24 epochs each, seed 0
STUDY_SHAPE = (192, 24552, 4)        # batch 8 x max_gt 24 at 256x512
STUDY_STEPS = 24 * (500 // 8)

# Put on a launcher child's path as ``sitecustomize``: in a process that
# torchrun started (LOCAL_RANK set), K1 is recorded (``K1_CHILD_RECORDER``),
# and at exit its launches, the calls' shapes and the last assignment input
# are written beside ``SMOKE_K1_REPORT``.
LAUNCH_SITECUSTOMIZE = r'''
import atexit, json, os
_out = os.environ.get("SMOKE_K1_REPORT")
if _out and "LOCAL_RANK" in os.environ:
''' + textwrap.indent(K1_CHILD_RECORDER + r'''
def _report():
    rank = os.environ["RANK"]
    if "input" in last:
        torch.save(last["input"], f"{_out}.rank{rank}.pt")
    with open(f"{_out}.rank{rank}.json", "w") as f:
        json.dump({"launches": sph2pob_iou_pairwise.launches,
                   "calls": calls}, f)

atexit.register(_report)
''', "    ")


@contextlib.contextmanager
def k1_recorded():
    """K1 as the assigner and the NMS call it, each call's (N, M, D)
    recorded and the last call's inputs kept; its launch counter set to 0
    before, read into ``launches`` after."""
    rec = {"shapes": [], "last": None}
    real = (single_stage.sph2pob_iou_pairwise,
            nms_module.sph2pob_iou_pairwise)

    def call(boxes1, boxes2):
        rec["shapes"].append([boxes1.shape[0], boxes2.shape[0],
                              boxes1.shape[1]])
        rec["last"] = (boxes1.clone(), boxes2.clone())
        return sph2pob_iou_pairwise(boxes1, boxes2)

    single_stage.sph2pob_iou_pairwise = nms_module.sph2pob_iou_pairwise = call
    sph2pob_iou_pairwise.launches = 0
    try:
        yield rec
    finally:
        single_stage.sph2pob_iou_pairwise, \
            nms_module.sph2pob_iou_pairwise = real
        torch.cuda.synchronize()
        rec["launches"] = sph2pob_iou_pairwise.launches


def _bitwise_on(inputs, what: str, reps: int) -> dict:
    """K1 against its plain version on recorded inputs: bitwise or fail."""
    b1, b2 = inputs
    res = {"input": what, **check_kernel(KERNELS[0], b1, b2, reps,
                                         identical=False)}
    if not res["bitwise_equal"]:
        raise AssertionError(f"{what}: K1 differs from its plain version "
                             f"by {res['max_abs_err']}")
    return res


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def audit_signature(b: dict) -> dict:
    """The published audit's findings (the assertions of
    ``tests/test_assign_audit.py::test_published_audit_signature_holds``),
    each True where the report ``b`` (backend -> summary) holds it."""
    fused, unfused, sph, fov, oracle = (b[k] for k in AUDIT_BACKENDS)

    def flip(s):
        return s["flip_confusion_vs_unbiased"]["anchor_category_flip_rate"]

    ppg = {k: s["pos_per_gt_mean"] for k, s in b.items()}
    return {
        "fused_vs_unfused_density": abs(ppg["sph2pob_efficient"]
                                        - ppg["sph2pob_efficient_jnp"])
        <= 0.02 * ppg["sph2pob_efficient_jnp"],
        "fused_vs_unfused_flips": abs(flip(fused) - flip(unfused)) < 1e-3,
        "sph_under_assigns": ppg["sph"] < 0.8 * ppg["sph2pob_efficient"]
        and ppg["sph"] < 0.8 * ppg["unbiased"]
        and sph["band_calibration_oracle_0.3_0.7"]["signed_err_mean"] < -0.05,
        "fov_healthy": abs(ppg["fov"] - ppg["sph2pob_efficient"])
        <= 0.2 * ppg["sph2pob_efficient"] and flip(fov) < 0.02,
        "positives_real": all(s["pos_oracle_iou_mean"] >= 0.5
                              for s in (fused, unfused, sph, fov, oracle)),
        "oracle_self_consistent": flip(oracle) == 0.0,
    }


@contextlib.contextmanager
def audit_timed():
    """``assign_audit``'s oracle overlaps and each backend's audit timed on
    the host clock, the card synchronised at the end of each; yields the
    seconds by backend (the oracle's under ``"oracle"``)."""
    seconds = {}
    real = audit_cli.oracle_overlaps, audit_cli.audit_backend

    def timed(key, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        return out

    audit_cli.oracle_overlaps = lambda *a, **k: timed("oracle", real[0],
                                                      *a, **k)
    audit_cli.audit_backend = lambda bk, *a, **k: timed(bk, real[1], bk,
                                                        *a, **k)
    try:
        yield seconds
    finally:
        audit_cli.oracle_overlaps, audit_cli.audit_backend = real


def run_audit_on_card(tmp: str, reps: int) -> tuple[dict, dict]:
    """``assign_audit.main`` on the committed train annotations, read only,
    held to the published report; returns its line and K1's check."""
    out = os.path.join(tmp, "audit")
    with k1_recorded() as rec, audit_timed() as by_backend:
        _, seconds = _timed(lambda: _said(lambda: audit_cli.main([
            "--data-root", SPHERE_BENCH, "--out", out, "--config",
            IOU_CONFIG, "--split", "train", "--batch", "8",
            "--backends", *AUDIT_BACKENDS])))
    if set(by_backend) != {"oracle", *AUDIT_BACKENDS}:
        raise AssertionError(f"audit: timed only {sorted(by_backend)}")
    with open(os.path.join(out, "audit.json")) as f:
        got = json.load(f)
    with open(PUBLISHED_AUDIT) as f:
        want = json.load(f)
    if rec["launches"] != AUDIT_BATCHES \
            or rec["shapes"] != [list(AUDIT_SHAPE)] * AUDIT_BATCHES:
        raise AssertionError(f"audit: {rec['launches']} K1 launches at "
                             f"{rec['shapes'][:3]}...")
    gaps = {}
    for name in AUDIT_BACKENDS:
        g, w = got["backends"][name], want["backends"][name]
        fl = [s["flip_confusion_vs_unbiased"]["anchor_category_flip_rate"]
              for s in (g, w)]
        gaps[name] = {
            "pos_per_gt_mean": [g["pos_per_gt_mean"], w["pos_per_gt_mean"]],
            "flip_rate": fl,
            "density_rel_gap": abs(g["pos_per_gt_mean"]
                                   - w["pos_per_gt_mean"])
            / w["pos_per_gt_mean"],
            "flip_gap": abs(fl[0] - fl[1])}
    signature = audit_signature(got["backends"])
    bad = [k for k, v in gaps.items()
           if not (v["density_rel_gap"] <= AUDIT_DENSITY_TOLERANCE
                   and v["flip_gap"] <= AUDIT_FLIP_TOLERANCE)]
    if (got["n_gts"], got["n_anchors"], got["n_images"]) \
            != (want["n_gts"], want["n_anchors"], want["n_images"]) or bad \
            or gaps["unbiased"]["flip_rate"][0] != 0.0 \
            or not all(signature.values()):
        raise AssertionError(f"audit against the published report: "
                             f"{got['n_gts']} GTs, {got['n_anchors']} "
                             f"anchors, off {bad}: {gaps}; {signature}")
    check = _bitwise_on(rec["last"], "study: the audit's last batch "
                        "(sph2pob_efficient)", reps)
    with open(os.path.join(out, "ASSIGN_AUDIT.md")) as f:
        rows = [line for line in f if line.startswith("| ")][1:]
    return {"n_images": got["n_images"], "n_gts": got["n_gts"],
            "n_anchors": got["n_anchors"], "seconds": seconds,
            "seconds_by_backend": by_backend,
            "against_published": gaps, "signature": signature,
            "rows": [r.strip() for r in rows],
            "k1_launches": rec["launches"]}, check


def _k1_per_run(rec: dict, fn_name: str, counts: dict):
    """``ap_study.<fn_name>`` that adds each call's K1 launches and shapes
    to ``counts`` under its run directory's name."""
    real = getattr(ap_cli, fn_name)

    def counted(*args, **kwargs):
        before, calls = sph2pob_iou_pairwise.launches, len(rec["shapes"])
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            run = os.path.basename(kwargs["work_dir"])
            counts.setdefault(run, {})[fn_name] = {
                "launches": sph2pob_iou_pairwise.launches - before,
                "shapes": rec["shapes"][calls:]}
    return real, counted


@contextlib.contextmanager
def k1_by_run():
    """K1 recorded (``k1_recorded``), and its launches and shapes in each
    study run's training and evaluation apart."""
    counts = {}
    with k1_recorded() as rec:
        patched = {name: _k1_per_run(rec, name, counts)
                   for name in ("train_variant", "eval_variant")}
        for name, (_, counted) in patched.items():
            setattr(ap_cli, name, counted)
        try:
            yield rec, counts
        finally:
            for name, (real, _) in patched.items():
                setattr(ap_cli, name, real)


def run_quick_study(tmp: str, seed: int, reps: int) -> tuple[dict, dict,
                                                              list]:
    """``ap_study.main(["--quick", "--out", TMP, "--seeds", seed])``: the
    six RetinaNet variants, 2 epochs each at 128x256 on data it writes under
    TMP; returns its line, K1's check and the run directories."""
    out = os.path.join(tmp, "ap_quick")
    with k1_by_run() as (rec, counts):
        said, seconds = _timed(lambda: _said(lambda: ap_cli.main(
            ["--quick", "--out", out, "--seeds", str(seed)])))
    with open(os.path.join(out, "report.json")) as f:
        report = json.load(f)
    with open(PUBLISHED_STUDY) as f:
        published = json.load(f)
    names = [n for n, _ in ap_cli.VARIANTS]
    runs = [os.path.join(out, f"{n}_s{seed}") for n in names]
    seed_keys = set(published["variants"]["ciou"]["seeds"]["0"])
    want_call = list(QUICK_SHAPE)
    for n in names:
        c = counts[f"{n}_s{seed}"]
        k1 = QUICK_STEPS if n in QUICK_K1_VARIANTS else 0
        if c["train_variant"]["launches"] != k1 \
                or c["train_variant"]["shapes"] != [want_call] * k1 \
                or c["eval_variant"]["launches"] != 0:
            raise AssertionError(f"quick study {n}: K1 {c}")
    missing = [r for r in runs
               if not os.path.exists(os.path.join(r, "eval_arrays.npz"))]
    entries = {n: report["variants"][n]["seeds"][str(seed)] for n in names}
    if set(report) != set(published) or missing \
            or any(set(e) != seed_keys for e in entries.values()) \
            or not os.path.exists(os.path.join(out, "AP_STUDY.md")) \
            or report["dataset"]["root"] != os.path.join(out, "sphere_bench"):
        raise AssertionError(f"quick study: keys {sorted(report)}, missing "
                             f"{missing}, entries {entries}")
    check = _bitwise_on(rec["last"], "study: the quick study's last "
                        "assignment input (ciou, 128x256)", reps)
    return {"seconds": seconds,
            "variants": {n: {"AP50": e["AP50"], "mAP": e["mAP"],
                             "train_seconds": e["train_seconds"],
                             "k1_launches": counts[f"{n}_s{seed}"][
                                 "train_variant"]["launches"]}
                         for n, e in entries.items()},
            "report_keys": sorted(report),
            "k1_launches": rec["launches"]}, check, runs


def jittered_gt_run(run: str, out: str, seed: int) -> str:
    """A run directory whose ``eval_arrays.npz`` holds ``run``'s val ground
    truth and, as detections of the GT's class with seeded scores in
    [0.05, 1), each GT jittered by 0.05-3 degrees and each GT's centre moved
    by 5-30 degrees: hits, mislocalised and hallucinated detections for the
    diagnosis to count (the quick study's 2-epoch runs detect nothing)."""
    a = dict(np.load(os.path.join(run, "eval_arrays.npz")))
    rng = np.random.default_rng(seed)
    gt = a["gt_boxes"].astype(np.float64)
    near = rng.uniform(0.05, 3.0, gt.shape) \
        * rng.choice([-1.0, 1.0], gt.shape)
    far = np.zeros_like(gt)
    far[..., :2] = rng.uniform(5.0, 30.0, gt[..., :2].shape) \
        * rng.choice([-1.0, 1.0], gt[..., :2].shape)
    a["boxes"] = np.concatenate([gt + near, gt + far], 1).astype(np.float32)
    a["labels"] = np.concatenate([a["gt_labels"]] * 2, 1)
    a["valid"] = np.concatenate([a["gt_mask"]] * 2, 1)
    a["scores"] = rng.uniform(0.05, 1.0, a["valid"].shape).astype(np.float32)
    os.makedirs(out)
    np.savez(os.path.join(out, "eval_arrays.npz"), **a)
    return out


def run_diagnosis_both(runs: list, ann: str) -> tuple[dict, dict]:
    """``detection_diagnosis.main`` on the runs on the card and on the CPU:
    integers equal, floats within ``TOOL_TOLERANCE``, and detections
    counted in at least one run. Returns the line and the card's report."""
    reports, seconds = {}, {}
    for dev in ("cuda", "cpu"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            reports[dev], seconds[dev] = _timed(lambda: diag_cli.main(
                [*runs, "--ann", ann, "--device", dev]))
        if len(reports[dev]) != len(runs):
            raise AssertionError(f"diagnosis on {dev}: {out.getvalue()}")
    if not any(r["all"]["dets"] for r in reports["cuda"].values()):
        raise AssertionError(f"diagnosis: no run has a detection to "
                             f"compare: {reports['cuda']}")
    gap = _same_numbers(reports["cuda"], reports["cpu"],
                        "detection_diagnosis")
    return {"seconds": seconds, "card_vs_cpu_max_float_gap": gap,
            "all": {k: v["all"] for k, v in reports["cuda"].items()}}, \
        reports["cuda"]


def run_converters(tmp: str, coco_ann: str, img_dir: str) -> dict:
    """Each converter through its ``main(argv)`` on files written here;
    the JSON it writes holds what was written."""
    root = os.path.join(tmp, "convert")
    os.makedirs(os.path.join(root, "Annotations"))
    for i in range(3):
        objects = "".join(
            f"<object><name>{name}</name><difficult>{d}</difficult><bndbox>"
            f"<xmin>{11 + 40 * j}</xmin><ymin>21</ymin><xmax>{61 + 40 * j}"
            f"</xmax><ymax>81</ymax></bndbox></object>"
            for j, (name, d) in enumerate((("person", 0), ("car", 1))))
        with open(os.path.join(root, "Annotations", f"{i:06d}.xml"), "w") as f:
            f.write(f"<annotation><filename>{i:06d}.jpg</filename><size>"
                    f"<width>400</width><height>200</height></size>"
                    f"{objects}</annotation>")
    inst = np.full((40, 96), 7, np.int32)
    inst[2:10, 3:12] = inst[30:38, 80:94] = 24      # one crowd id, 2 parts
    inst[12:25, 20:40] = 26001
    gt_dir = os.path.join(root, "gtFine", "aachen")
    os.makedirs(gt_dir)
    from PIL import Image

    Image.fromarray(inst).save(
        os.path.join(gt_dir, "aachen_000000_000019_gtFine_instanceIds.png"))
    raw = os.path.join(root, "raw.json")
    with open(raw, "w") as f:
        json.dump({"images": [], "annotations": [
            {"id": 1, "bbox": [0.0, 0.0, 30.0, 20.0]}]}, f)
    with open(os.path.join(root, "classes.txt"), "w") as f:
        f.write("\n".join(f"class_{i}" for i in range(4)) + "\n")
    out = {k: os.path.join(root, f"{k}.json")
           for k in ("voc", "city", "coco", "metas", "radians")}
    for fn, argv in (
            (voc_cli.main, [os.path.join(root, "Annotations"), out["voc"]]),
            (city_cli.main, [os.path.join(root, "gtFine"), out["city"]]),
            (split_cli.main, [coco_ann, os.path.join(root, "splits"),
                              "--labeled-percent", "25", "--fold", "2"]),
            (images_cli.main, [img_dir, os.path.join(root, "classes.txt"),
                               out["coco"]]),
            (metas_cli.main, ["--img-dir", img_dir, "--out", out["metas"]]),
            (anno_cli.main, [raw, "--out", out["radians"]])):
        _said(lambda: fn(argv))
    got = {}
    for k, path in out.items():
        with open(path) as f:
            got[k] = json.load(f)
    with open(coco_ann) as f:
        n_coco = len(json.load(f)["images"])
    n_png = len([f for f in os.listdir(img_dir) if f.endswith(".png")])
    splits = sorted(os.listdir(os.path.join(root, "splits")))
    with open(os.path.join(root, "splits", "instances_train.1@25.json")) as f:
        labeled = json.load(f)
    counts = {
        "voc": [len(got["voc"]["images"]), len(got["voc"]["annotations"]),
                sum(a["iscrowd"] for a in got["voc"]["annotations"])],
        "cityscapes": [len(got["city"]["annotations"]),
                       sum(a["iscrowd"] for a in got["city"]["annotations"])],
        "split_coco": [len(splits), len(labeled["images"])],
        "images2coco": len(got["coco"]["images"]),
        "get_image_metas": len(got["metas"]),
        "convert_anno": got["radians"]["annotations"][0]["bbox"][:2]}
    want = {"voc": [3, 6, 3], "cityscapes": [3, 2],
            "split_coco": [4, round(n_coco * 0.25)], "images2coco": n_png,
            "get_image_metas": n_png, "convert_anno": [180.0, 90.0]}
    if counts != want:
        raise AssertionError(f"converters: {counts}, expected {want}")
    return counts


def _launched(argv: list, env: dict, log: str) -> float:
    """A launcher script as its own process group, its output to ``log``;
    killed at ``LAUNCH_TIMEOUT_S``. Returns its seconds."""
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=LAUNCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait(timeout=30)
    if rc != 0:
        with open(log) as f:
            raise AssertionError(f"{argv[0]} ended with {rc}:\n"
                                 f"{f.read()[-3000:]}")
    return time.perf_counter() - t0


def run_launchers(tmp: str, reps: int) -> tuple[dict, int, dict]:
    """``scripts/dist_train.sh CONFIG 1 --synthetic``: 2 steps of the
    rotated config under torchrun on the card (K1 once a step at
    ``ASSIGN_SHAPE``, as the child reports), then ``scripts/dist_test.sh``
    on its checkpoint (K1 once a val image of its 16). Returns the line, the
    children's K1 launches and K1's check on the child's last assignment
    input."""
    site = os.path.join(tmp, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_SITECUSTOMIZE)
    scripts = os.path.join(ROOT, "sph_retina_tpu_torch", "scripts")
    work = os.path.join(tmp, "launched")
    reports = {k: os.path.join(tmp, f"k1_{k}") for k in ("train", "test")}
    env = dict(os.environ, PYTHON=sys.executable, PORT=str(free_port()),
               PYTHONPATH=os.pathsep.join(
                   [site] + ([os.environ["PYTHONPATH"]]
                             if os.environ.get("PYTHONPATH") else [])))
    torch.cuda.empty_cache()
    seconds = {"dist_train": _launched(
        [os.path.join(scripts, "dist_train.sh"), CONFIG, "1", "--synthetic",
         "--max-epochs", "1", "--work-dir", work, "--cfg-options",
         f"data.n_synthetic={LAUNCH_IMAGES}", "evaluation=None",
         "log_config.interval=1"],
        dict(env, SMOKE_K1_REPORT=reports["train"]),
        os.path.join(tmp, "dist_train.log"))}
    env["PORT"] = str(free_port())
    seconds["dist_test"] = _launched(
        [os.path.join(scripts, "dist_test.sh"), CONFIG,
         os.path.join(work, "ckpts"), "1", "--synthetic", "--out",
         os.path.join(tmp, "dist_test.json")],
        dict(env, SMOKE_K1_REPORT=reports["test"]),
        os.path.join(tmp, "dist_test.log"))
    said = {}
    for k, path in reports.items():
        with open(f"{path}.rank0.json") as f:
            said[k] = json.load(f)
    with open(os.path.join(tmp, "dist_train.log")) as f:
        train_log = f.read()
    records = [r for r in _records(work) if r["prefix"] == "train"]
    steps = LAUNCH_IMAGES // TRAIN_BATCH
    with open(os.path.join(tmp, "dist_test.json")) as f:
        metrics = json.load(f)
    if "process 0/1; backend: nccl; device: cuda" not in train_log \
            or said["train"]["calls"]["assign"] \
            != [list(ASSIGN_SHAPE)] * steps \
            or said["train"]["launches"] != steps \
            or [r["step"] for r in records] != list(range(1, steps + 1)) \
            or said["test"]["launches"] != LAUNCH_TEST_IMAGES \
            or len(said["test"]["calls"]["nms"]) != LAUNCH_TEST_IMAGES \
            or not {"AP50", "mAP"} <= set(metrics):
        raise AssertionError(f"the launchers: {said}, {records}, {metrics}"
                             f"\n{train_log[-2000:]}")
    b1, b2 = torch.load(f"{reports['train']}.rank0.pt")
    check = _bitwise_on((b1.cuda(), b2.cuda()), "study: dist_train.sh's "
                        "child, its last assignment input", reps)
    launches = said["train"]["launches"] + said["test"]["launches"]
    return {"seconds": seconds,
            "losses": [r["loss"] for r in records],
            "test_metrics": {k: metrics[k] for k in ("AP50", "mAP")},
            "k1_launches": {k: v["launches"] for k, v in said.items()}}, \
        launches, check


def phase_study(seed: int, reps: int) -> tuple[int, list]:
    """The sphere-bench study tools, the dataset converters and the
    launchers. (1) ``assign_audit.main`` on the committed train annotations
    (500 images, 5 backends and the oracle, batch 8) held to the published
    ``work_dirs/assign_audit/audit.json``: the counts of GTs and anchors,
    each backend's positives a GT within 1 % and its flip rate within 1e-3,
    the oracle's 0.0, the published findings; K1 63 times at (88, 24552)
    D=4, bitwise on the last batch. (2) ``ap_study.main(["--quick"])``: the
    six RetinaNet variants (2 epochs, 128x256) on data it writes under its
    output; K1 once a step in ``l1`` and ``ciou`` at (192, 6138) D=4 and
    never in the others; the report's keys the published report's, every
    ``eval_arrays.npz`` written. (3) ``detection_diagnosis`` on those runs
    and on a run of the val ground truth jittered into detections, on the
    card and on the CPU. (4) The seven converters. (5)
    ``dist_train.sh`` and ``dist_test.sh``. The committed annotations'
    sha256 the same after the phase as before. Returns K1's launches (the
    launchers' children's as they report them) and its checks."""
    t_phase = time.perf_counter()
    resolve_device()
    before = [_sha256(p) for p in SPHERE_BENCH_ANNOTATIONS]
    checks = []
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        audit, check = run_audit_on_card(tmp, reps)
        checks.append(check)
        torch.cuda.empty_cache()
        quick, check, runs = run_quick_study(tmp, seed, reps)
        checks.append(check)
        quick_root = os.path.join(tmp, "ap_quick", "sphere_bench")
        val_ann = os.path.join(quick_root, "annotations",
                               "instances_val.json")
        diagnosis, _ = run_diagnosis_both(
            runs + [jittered_gt_run(runs[0], os.path.join(tmp, "jittered_gt"),
                                    seed)], val_ann)
        converters, seconds = _timed(lambda: run_converters(
            tmp, val_ann, os.path.join(quick_root, "images")))
        converters["seconds"] = seconds
        launchers, child_launches, check = run_launchers(tmp, reps)
        checks.append(check)
    after = [_sha256(p) for p in SPHERE_BENCH_ANNOTATIONS]
    if after != before:
        raise AssertionError("the phase changed the committed sphere-bench "
                             "annotations")
    launches = audit["k1_launches"] + quick["k1_launches"] + child_launches
    emit({"phase": "study", "assign_audit": audit, "ap_study_quick": quick,
          "detection_diagnosis": diagnosis, "converters": converters,
          "launchers": launchers,
          "committed_annotations_sha256_unchanged": before,
          "kernel_launches": launches, "kernel_on_inputs": checks,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches, checks


def phase_study_full(seed: int, reps: int) -> None:
    """``--study``: the full sphere-bench (500 / 100 images, 12 classes,
    256x512, seed 0) written into a temporary root, both annotation files
    byte-identical to the committed ones; the RetinaNet ``l1`` and ``ciou``
    variants trained 24 epochs at seed 0 on the card at full width (K1 once
    a step at (192, 24552) D=4), evaluated with unbiased matching, and
    diagnosed on the card and on the CPU (integers equal, floats within
    ``TOOL_TOLERANCE``); AP50, mAP, AP50 by stratum and the training seconds beside
    the published JAX study's seed-0 figures and its range over seeds. A
    figure below the lowest JAX seed is flagged, not failed."""
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        root = os.path.join(tmp, "sphere_bench")
        _, write_s = _timed(lambda: _said(lambda: synth_cli.main(
            ["--root", root])))
        identical = [_sha256(os.path.join(root, "annotations",
                                          os.path.basename(p)))
                     == _sha256(p) for p in SPHERE_BENCH_ANNOTATIONS]
        if not all(identical):
            raise AssertionError(f"the written annotations differ from the "
                                 f"committed ones: {identical}")
        out = os.path.join(tmp, "study")
        variants = [(n, o) for n, o in ap_cli.VARIANTS if n in STUDY_VARIANTS]
        with k1_by_run() as (rec, counts):
            report, study_s = _timed(lambda: ap_cli.run_study(
                data_root=root, out_dir=out, seeds=[seed],
                variants=variants))
        want_call = list(STUDY_SHAPE)
        for n in STUDY_VARIANTS:
            c = counts[f"{n}_s{seed}"]["train_variant"]
            if c["launches"] != STUDY_STEPS \
                    or c["shapes"] != [want_call] * STUDY_STEPS:
                raise AssertionError(f"--study {n}: {c['launches']} K1 "
                                     f"launches")
        check = _bitwise_on(rec["last"], "--study: the last assignment "
                            "input (ciou)", reps)
        val_ann = os.path.join(root, "annotations", "instances_val.json")
        diagnosis_line, diagnosis = run_diagnosis_both(
            [os.path.join(out, f"{n}_s{seed}") for n in STUDY_VARIANTS],
            val_ann)
    with open(PUBLISHED_STUDY) as f:
        published = json.load(f)["variants"]
    rows = {}
    for n in STUDY_VARIANTS:
        e = report["variants"][n]["seeds"][str(seed)]
        jax_seeds = {s: m["AP50"] for s, m in published[n]["seeds"].items()
                     if "AP50" in m}
        rows[n] = {
            "AP50": e["AP50"], "mAP": e["mAP"], "AP75": e["AP75"],
            "strata_AP50": {k: v["AP50"] for k, v in e["strata"].items()},
            "train_seconds": e["train_seconds"],
            "k1_launches": counts[f"{n}_s{seed}"]["train_variant"][
                "launches"],
            "jax_seed0_AP50": jax_seeds.get("0"),
            "jax_AP50_range": [min(jax_seeds.values()),
                               max(jax_seeds.values())],
            "jax_seeds": len(jax_seeds),
            "below_lowest_jax_seed": e["AP50"] < min(jax_seeds.values()),
            "diagnosis": diagnosis[f"{n}_s{seed}"]}
    emit({"phase": "study_full", "dataset_write_seconds": write_s,
          "annotations_byte_identical": identical,
          "study_seconds": study_s, "variants": rows,
          "diagnosis_seconds": diagnosis_line["seconds"],
          "diagnosis_card_vs_cpu_max_float_gap":
              diagnosis_line["card_vs_cpu_max_float_gap"],
          "kernel_on_input": check,
          "phase_seconds": time.perf_counter() - t_phase})


SHARDING_STEPS = 4          # (a): batch 4 at world 1 over NCCL
SHARDING_RANK_STEPS = 2     # (b), (c), (e), (f): 2 steps of two gloo ranks
SHARDING_FSDP_BATCH = 4     # (b): the global batch, 2 images a rank
SHARDING_SPACE_BATCH = 2    # (c), (e), (f): each space rank the whole 2
SHARDING_CHILD_S = 300.0    # (b)-(f): each rank's deadline
SHARDING_SHAPE = (128, 98208, 5)  # (b): each rank's 2 images x max_gt 64
SHARDING_SPLIT_SHAPE = (128, 49104, 5)  # (c): against the rank's own anchors
SHARDING_SSD_SHAPE = (128, 49056, 4)    # (f): the gathered head, every anchor
SHARDING_LOSS_RTOL = 1e-4   # (c), (e), (f): tests/test_sharding.py's
SHARDING_NECK_WIDTHS = [128, 64, 32, 16, 8]  # (c), (e): P3-P7 at 1024, split
SHARDING_HEAD_COLUMNS = [64, 32, 16, 8, 4]   # (c), (e): a rank's head inputs
# (b), (c) the rotated RetinaNet, (e) FCOS, (f) SSD: (part, space size,
# batch, config)
SHARDING_PARTS = (("b", 1, SHARDING_FSDP_BATCH, CONFIG),
                  ("c", 2, SHARDING_SPACE_BATCH, CONFIG),
                  ("e", 2, SHARDING_SPACE_BATCH, FCOS_CONFIG),
                  ("f", 2, SHARDING_SPACE_BATCH, SSD_CONFIG))
# (c)'s predict: the classifier's weights scaled so that the random model's
# logits (std ~0.5 about the prior's -4.6 after two steps) spread past the
# score threshold without saturating the sigmoid
SHARDING_PREDICT_CLS_SCALE = 4.0
SHARDING_PREDICT_TOLERANCE = {"rtol": 1e-3, "atol": 1e-4}  # the CPU test's
OVERLAP_BOXES = 256         # (d): seeded boxes against the config's anchors
OVERLAP_TOLERANCE = {"rtol": 1e-5, "atol": 1e-6}  # (d): the JAX test's

# The ranks of phase (b)-(f), run as ``python -c SHARDING_CHILD SPEC_JSON
# K1_INPUT_FILE TIMEOUT_S`` (``_ranks_of_one_card``): K1 recorded, then
# ``sharding_child`` writing beside that file. Prints one JSON line.
SHARDING_CHILD = r'''
import json, os, sys
sys.modules["torch.utils.tensorboard"] = None
''' + K1_CHILD_RECORDER + r'''
import chip_smoke
spec, out, timeout_s = json.loads(sys.argv[1]), sys.argv[2], float(sys.argv[3])
print(json.dumps(chip_smoke.sharding_child(spec, os.path.dirname(out),
                                           timeout_s, calls, last)),
      flush=True)
'''


def _state_bytes(model, optimizer) -> int:
    """Bytes this process holds of parameters, momentum buffers and EMA
    shadows."""
    tensors = list(model.parameters()) + optimizer.bufs + (optimizer.ema
                                                           or [])
    return sum(t.numel() * t.element_size() for t in tensors)


class _Transients:
    """Forward hooks on every leaf module of a model: for each call, the
    bytes allocated on the card above those allocated at its end, since the
    previous call ended (its workspace and temporaries: the allocator's own
    counts, no synchronisation). ``peak`` keeps the process's peak, which
    each call's reset of it would lose."""

    def __init__(self, model, device):
        self.device, self.rows, self.peak = device, [], 0
        self.handles = [m.register_forward_hook(self._hook(name))
                        for name, m in model.named_modules()
                        if not any(m.children())]

    def _hook(self, name):
        def hook(module, args, out):
            top = torch.cuda.max_memory_allocated(self.device)
            self.peak = max(self.peak, top)
            self.rows.append((top - torch.cuda.memory_allocated(self.device),
                              name, list(getattr(args[0], "shape", ()))))
            torch.cuda.reset_peak_memory_stats(self.device)
        return hook

    def remove(self) -> list:
        """The hooks removed; the three largest calls."""
        for h in self.handles:
            h.remove()
        return [{"bytes": b, "module": n, "input": shape}
                for b, n, shape in sorted(self.rows, reverse=True)[:3]]


def sharded_training(cfg: dict, seed: int, device, steps: int, mesh=None,
                     fsdp: bool = False, flops: bool = False) -> dict:
    """``steps`` train steps of ``cfg``'s model on its synthetic set, the
    config's ``samples_per_gpu`` being the global batch: as one process
    (``mesh`` None), or this rank's part of each batch
    (``shard_batch_spatial``) with the model partitioned over ``mesh``'s
    space axis and, with ``fsdp``, its state sharded over the data axis.
    Returns the model, its detector config and optimiser, each step's
    metrics (summed over the ranks ``global_metrics`` sums over) and ms
    (host clock, synchronised), the bytes of state held before and after
    the sharding, the process's bytes allocated on the card at the call's
    start and its peak from there (``torch.cuda.max_memory_allocated``),
    the last batch's whole images and, with ``flops``,
    ``get_flops.count_flops`` of one forward of the last batch's first
    image (this rank's columns) and the first step's three largest
    transients of a module's forward (``_Transients``)."""
    torch.cuda.reset_peak_memory_stats(device)
    start_bytes = torch.cuda.memory_allocated(device)
    family = get_family(cfg)
    loader, _ = train_cli.synthetic_loaders(cfg, seed)
    model, det_cfg = family.build(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    model = model.to(device)
    optimizer = build_tx(cfg, model, steps_per_epoch=len(loader))
    whole = _state_bytes(model, optimizer)
    if mesh is not None:
        parallel.partition_spatially(model, mesh)
        if fsdp:
            parallel.shard_state_fsdp(model, optimizer, mesh)
    step = make_generic_train_step(family, model, det_cfg, optimizer,
                                   seed=seed)
    metrics, step_ms = [], []
    probe = _Transients(model, device) if flops else None
    transients = None
    for batch in itertools.islice(loader.epoch(0), steps):
        batch = to_device({k: v for k, v in batch.items() if k != "img_id"},
                          device)
        images = batch["images"]
        if mesh is not None:
            batch = parallel.shard_batch_spatial(batch, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = parallel.global_metrics(step(batch))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in got.items()})
        if probe is not None and transients is None:
            transients = probe.remove()
    if len(metrics) != steps or not all(
            math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"{len(metrics)} steps, metrics {metrics}")
    peak = max(torch.cuda.max_memory_allocated(device),
               probe.peak if probe is not None else 0)
    count = None
    if flops:
        with torch.no_grad():
            count = flops_cli.count_flops(
                model, maybe_normalize_images(batch["images"][:1])).total
    return {"model": model, "det_cfg": det_cfg, "optimizer": optimizer,
            "metrics": metrics, "step_ms": step_ms, "whole_bytes": whole,
            "local_bytes": _state_bytes(model, optimizer),
            "start_bytes": start_bytes, "peak_bytes": peak,
            "transients": transients, "images": images,
            "forward_flops": count}


def _sharding_cfg(batch: int, steps: int, options=PARALLEL_OPTIONS,
                  config: str = CONFIG) -> dict:
    return apply_overrides(load_config(config), [
        f"data.samples_per_gpu={batch}", f"data.n_synthetic={batch * steps}",
        *options])


def _head_columns(axis) -> list:
    """The columns each level's first head conv sees on this rank (before
    its halo): the plan's global input widths, split where they divide."""
    first = axis.head.cls_conv_0
    return [g // axis.size if g % axis.size == 0 else g
            for k, g in axis.plan.items()
            if isinstance(k, tuple) and k[0] is first]


def _kept_targets(kept: dict):
    """``single_stage.anchor_targets`` that keeps its last labels (on the
    host) in ``kept["labels"]``."""
    real = single_stage.anchor_targets

    def targets(*args, **kwargs):
        t = real(*args, **kwargs)
        kept["labels"] = t.labels.cpu()
        return t

    return targets


def _predict_whole(model, cfg: dict, det_cfg, images) -> dict:
    """(c)'s predict on whole images, the classifier scaled by
    ``SHARDING_PREDICT_CLS_SCALE``: the family's ``predict_fn`` (on a
    partitioned model, each rank its columns, the head's levels joined
    before the top-k) and the head's per-level outputs joined
    (``whole_levels``), on the host. Every rank of a partitioned model
    calls it."""
    model.eval()
    with torch.no_grad():
        model.bbox_head.retina_cls.weight.mul_(SHARDING_PREDICT_CLS_SCALE)
        got = get_family(cfg).predict_fn(model, det_cfg)(images)
        x = maybe_normalize_images(images)
        axis = getattr(model, "space_axis", None)
        heads = parallel.sharding.whole_levels(
            model, model(x if axis is None else axis.columns(x)),
            det_cfg.featmap_sizes())
    return {"detections": {k: v.cpu() for k, v in got._asdict().items()},
            "heads": [torch.cat(levels, 1).cpu() for levels in heads]}


def sharding_child(spec: dict, out: str, timeout_s: float, calls: dict,
                   last: dict) -> dict:
    """One of the two gloo ranks of phase ``sharding``: (b) FSDP over data
    2, (c) data 1 x space 2 (the split RetinaNet head), (e) the same for
    FCOS, (f) for SSD (its gathered head), (d) the row-sharded overlaps.
    Writes rank 0's gathered parameters, its checkpoint, each rank's last
    assignment input and, in (c), its last labels and rank 0's predict on
    the whole last batch (``_predict_whole``) under ``out``; returns what
    the phase reads."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    device, seed = torch.device(spec["device"]), spec["seed"]
    rank, world = parallel.init_distributed(
        "torch", backend="gloo", timeout_s=timeout_s, device=device)
    report = {"rank": rank, "world": world,
              "backend": torch.distributed.get_backend()}
    kept, real_targets = {}, single_stage.anchor_targets
    single_stage.anchor_targets = _kept_targets(kept)
    try:
        for part, space, batch, config in SHARDING_PARTS:
            parallel.set_data_axis()
            mesh = parallel.make_mesh(space=space)
            calls["assign"].clear()
            kept.clear()
            sph2pob_iou_pairwise.launches = 0
            cfg = _sharding_cfg(batch, SHARDING_RANK_STEPS, config=config)
            run = sharded_training(
                cfg, seed, device, SHARDING_RANK_STEPS, mesh,
                fsdp=part == "b", flops=part in ("c", "e"))
            torch.cuda.synchronize()
            launches = sph2pob_iou_pairwise.launches
            model, optimizer = run["model"], run["optimizer"]
            if part == "b":
                runner.RankZeroCheckpointer(os.path.join(out, "b_ckpt")) \
                    .save(model, optimizer, 1)
            params = model.state_dict()  # gathered: every rank calls it
            if rank == 0:
                torch.save({k: v.cpu() for k, v in params.items()},
                           os.path.join(out, f"{part}_params.pt"))
            if "input" in last:
                torch.save(last.pop("input"), os.path.join(
                    out, f"{part}_k1_input_rank{rank}.pt"))
            if part == "c":
                torch.save(kept["labels"], os.path.join(
                    out, f"{part}_labels_rank{rank}.pt"))
                predicted = _predict_whole(model, cfg, run["det_cfg"],
                                           run["images"])
                if rank == 0:
                    torch.save({"images": run["images"].cpu(), **predicted},
                               os.path.join(out, "c_predict.pt"))
            axis = getattr(model, "space_axis", None)
            report[part] = {
                "metrics": run["metrics"], "step_ms": run["step_ms"],
                "state_bytes": run["local_bytes"],
                "unsharded_state_bytes": run["whole_bytes"],
                "start_bytes": run["start_bytes"],
                "peak_bytes": run["peak_bytes"],
                "transients": run["transients"],
                "forward_flops": run["forward_flops"],
                "sharded_tensors": sum(hasattr(p, "fsdp")
                                       for p in model.parameters()),
                "neck_widths": None if axis is None else [
                    g for k, g in axis.plan.items()
                    if isinstance(k, tuple) and k[0] == "out"],
                "head_columns": None if axis is None or axis.head is None
                else _head_columns(axis),
                "launches": launches, "assign_calls": list(calls["assign"])}
            del run, model, optimizer, params
            torch.cuda.empty_cache()
        parallel.set_data_axis()
        mesh = parallel.make_mesh()
        cfg = load_config(CONFIG)
        anchors = get_family(cfg).build(cfg)[1].flat_anchors(device)
        boxes = torch.from_numpy(generate_boxes(OVERLAP_BOXES, 5,
                                                seed=seed)).to(device)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = parallel.sharded_pairwise_overlaps(anchors, boxes, mesh)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        report["d"] = {"shape": list(got.shape), "ms": ms}
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = sph_overlaps(anchors, boxes, "sph2pob_efficient",
                                is_aligned=False)
            torch.cuda.synchronize()
            report["d"].update(
                unsharded_ms=(time.perf_counter() - t0) * 1e3,
                max_abs_gap=float((got - want).abs().max()),
                within_tolerance=bool(torch.allclose(got, want,
                                                     **OVERLAP_TOLERANCE)),
                finite=bool(torch.isfinite(got).all()))
        parallel.coordination_barrier("done", timeout_s=timeout_s)
    finally:
        single_stage.anchor_targets = real_targets
        parallel.set_data_axis()
        torch.distributed.destroy_process_group()
    return report


def _predict_against_one_process(path: str, params: str, device) -> dict:
    """(c)'s predict of the partitioned model (``path``) against one
    process's of the same weights (``params``) on the same whole images, in
    fp32 with TF32 off as the ranks ran: the head's joined outputs, and the
    boxes and scores of the valid detections, within
    ``SHARDING_PREDICT_TOLERANCE``; the valid detections, their labels and
    anchor indices equal. Fails where no detection is made."""
    got = torch.load(path)
    cfg = _sharding_cfg(SHARDING_SPACE_BATCH, SHARDING_RANK_STEPS)
    model, det_cfg = get_family(cfg).build(cfg)
    model.load_state_dict(torch.load(params))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = _predict_whole(model.to(device), cfg, det_cfg,
                              got["images"].to(device))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    g, w = got["detections"], want["detections"]
    valid = w["valid"]
    said = {"detections": int(valid.sum()),
            "distinct_scores": int(w["scores"][valid].unique().numel()),
            "score_range": [float(w["scores"][valid].min()),
                            float(w["scores"][valid].max())],
            "mismatches": {k: int((g[k] != w[k])[valid].sum())
                           for k in ("valid", "labels", "inds")},
            "max_abs_gap": {}, "tolerance": SHARDING_PREDICT_TOLERANCE,
            "classifier_scale": SHARDING_PREDICT_CLS_SCALE}
    gaps = said["max_abs_gap"]
    for name, a, b in zip(("head_cls", "head_reg"), got["heads"],
                          want["heads"]):
        gaps[name] = float((a - b).abs().max())
        if a.shape != b.shape or not torch.allclose(
                a, b, **SHARDING_PREDICT_TOLERANCE):
            raise AssertionError(f"(c) the head's joined outputs: {said}")
    if said["detections"] == 0 or any(said["mismatches"].values()):
        raise AssertionError(f"(c) predict: {said}")
    for k in ("boxes", "scores"):
        gaps[k] = float((g[k][valid] - w[k][valid]).abs().max())
        if not torch.allclose(g[k][valid], w[k][valid],
                              **SHARDING_PREDICT_TOLERANCE):
            raise AssertionError(f"(c) predict: {said}")
    return said


def _param_gap(got: dict, want: dict) -> float:
    """max|got - want| over the floating tensors."""
    return max(float((got[k].float() - v.float()).abs().max())
               for k, v in want.items() if v.is_floating_point())


def phase_sharding(seed: int, reps: int, smi: str) -> tuple[int, list]:
    """``parallel/sharding.py`` on the rotated config at full width (see the
    module docstring, phase 23). Returns K1's launches and its checks on the
    assignment inputs of (a) and of (c)'s rank 0. Prints the split heads'
    line (each rank's head columns, peak memory, forward FLOPs, steady step
    ms, and one process's) before the phase's own."""
    device = resolve_device()
    t_phase = time.perf_counter()
    seconds, checks, launches = {}, [], 0
    calls, real = [], single_stage.sph2pob_iou_pairwise
    kept = {}

    def recording(boxes1, boxes2):
        kept["input"] = (boxes1.clone(), boxes2.clone())
        return _recording(real, calls)(boxes1, boxes2)

    # (a) world 1 over NCCL against one process without a group
    cfg = load_config(CONFIG)
    single_stage.sph2pob_iou_pairwise = recording
    try:
        runs = {}
        for kind in ("none", "nccl"):
            sph2pob_iou_pairwise.launches = 0
            t0 = time.perf_counter()
            if kind == "none":
                runs[kind] = sharded_training(cfg, seed, device,
                                              SHARDING_STEPS)
            else:
                with torchrun_environment(0, 1, free_port()), \
                        parallel.process_group("torch", device) as (_, world):
                    backend = torch.distributed.get_backend()
                    mesh = parallel.make_mesh()
                    runs[kind] = sharded_training(cfg, seed, device,
                                                  SHARDING_STEPS, mesh,
                                                  fsdp=True)
                    runs[kind]["params"] = {
                        k: v.detach().cpu() for k, v in
                        runs[kind]["model"].state_dict().items()}
            torch.cuda.synchronize()
            runs[kind]["launches"] = sph2pob_iou_pairwise.launches
            seconds[f"a_{kind}"] = time.perf_counter() - t0
    finally:
        single_stage.sph2pob_iou_pairwise = real
    if torch.distributed.is_initialized():
        raise AssertionError("phase (a) left its process group open")
    none, nccl = runs["none"], runs["nccl"]
    assert_full_width_training(cfg, nccl["model"], nccl["det_cfg"],
                               nccl["optimizer"], device)
    want = {k: v.detach().cpu() for k, v in
            none["model"].state_dict().items()}
    start = get_family(cfg).build(cfg)[0]
    start.init_weights(torch.Generator().manual_seed(seed))
    gap_a = _update_gap(nccl["params"], want, start.state_dict())
    max_gap_a = _param_gap(nccl["params"], want)
    if not gap_a <= PARALLEL_TOLERANCE:
        raise AssertionError(f"(a): the update is {gap_a} from one "
                             f"process's (tolerance {PARALLEL_TOLERANCE})")
    want_call = [list(ASSIGN_SHAPE[::2]), list(ASSIGN_SHAPE[1:])]
    if calls != [want_call] * (2 * SHARDING_STEPS) or any(
            r["launches"] != SHARDING_STEPS for r in runs.values()):
        raise AssertionError(f"(a): K1 was called at {calls}")
    launches += none["launches"] + nccl["launches"]
    checks.append({"input": "sharding (a): the last assignment input at "
                            "world 1 over NCCL",
                   **check_kernel(KERNELS[0], *kept["input"], reps,
                                  identical=False)})
    a = {"backend": backend, "world": world, "update_gap": gap_a,
         "max_abs_param_gap": max_gap_a, "tolerance": PARALLEL_TOLERANCE,
         "sharded_tensors": sum(hasattr(p, "fsdp")
                                for p in nccl["model"].parameters()),
         "losses": {k: [m["loss"] for m in r["metrics"]]
                    for k, r in runs.items()},
         "step_ms": {k: r["step_ms"] for k, r in runs.items()},
         "kernel_launches": {k: r["launches"] for k, r in runs.items()}}
    del runs, none, nccl, want, start
    torch.cuda.empty_cache()

    # the one-process references of (b), (c), (e) and (f), fp32 with TF32 off
    torch.backends.cudnn.deterministic = True
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    refs, theta0, labels = {}, {}, {}
    real_targets = single_stage.anchor_targets
    single_stage.anchor_targets = _kept_targets(labels)
    try:
        for part, _, batch, config in SHARDING_PARTS:
            sph2pob_iou_pairwise.launches = 0
            labels.clear()
            cfg = _sharding_cfg(batch, SHARDING_RANK_STEPS, config=config)
            t0 = time.perf_counter()
            run = sharded_training(cfg, seed, device, SHARDING_RANK_STEPS,
                                   flops=part in ("c", "e"))
            torch.cuda.synchronize()
            seconds[f"{part}_one_process"] = time.perf_counter() - t0
            launches += sph2pob_iou_pairwise.launches
            refs[part] = {"metrics": run["metrics"], "step_ms":
                          run["step_ms"], "params": {
                              k: v.detach().cpu() for k, v in
                              run["model"].state_dict().items()},
                          "start_bytes": run["start_bytes"],
                          "peak_bytes": run["peak_bytes"],
                          "transients": run["transients"],
                          "forward_flops": run["forward_flops"],
                          "labels": labels.get("labels")}
            del run
            torch.cuda.empty_cache()
            start = get_family(cfg).build(cfg)[0]
            start.init_weights(torch.Generator().manual_seed(seed))
            theta0[part] = start.state_dict()
    finally:
        single_stage.anchor_targets = real_targets
        torch.backends.cudnn.allow_tf32 = tf32
    cfg = _sharding_cfg(SHARDING_FSDP_BATCH, SHARDING_RANK_STEPS)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        ranks = _ranks_of_one_card({"seed": seed, "device": device.type},
                                   tmp, child=SHARDING_CHILD,
                                   deadline_s=SHARDING_CHILD_S)
        seconds["two_ranks"] = time.perf_counter() - t0
        (r0, _), (r1, _) = ranks
        for r, said in ranks:
            if r["backend"] != "gloo" or r["world"] != 2:
                raise AssertionError(f"rank {r['rank']} said {said[-2000:]}")
            # K1 once a step a rank: (b) against every anchor, (c) against
            # the rank's own, (f) SSD's against every anchor (its head is
            # gathered); FCOS (e) assigns without it
            for part, shape, n in (("b", SHARDING_SHAPE, SHARDING_RANK_STEPS),
                                   ("c", SHARDING_SPLIT_SHAPE,
                                    SHARDING_RANK_STEPS), ("e", None, 0),
                                   ("f", SHARDING_SSD_SHAPE,
                                    SHARDING_RANK_STEPS)):
                if r[part]["assign_calls"] != [list(shape or ())] * n \
                        or r[part]["launches"] != n:
                    raise AssertionError(
                        f"rank {r['rank']} ({part}): {r[part]['launches']} "
                        f"K1 launches, calls {r[part]['assign_calls']}")
                launches += r[part]["launches"]
        result = {}
        for part in ("b", "c", "e", "f"):
            got = torch.load(os.path.join(tmp, f"{part}_params.pt"))
            gap = _update_gap(got, refs[part]["params"], theta0[part])
            if not gap <= PARALLEL_TOLERANCE:
                raise AssertionError(
                    f"({part}): the two ranks' update is {gap} from one "
                    f"process's (tolerance {PARALLEL_TOLERANCE})")
            result[part] = {"update_gap": gap,
                            "losses": [m["loss"] for m in r0[part]
                                       ["metrics"]],
                            "one_process_losses": [
                                m["loss"] for m in refs[part]["metrics"]],
                            "step_ms": {"rank0": r0[part]["step_ms"],
                                        "rank1": r1[part]["step_ms"],
                                        "one_process":
                                            refs[part]["step_ms"]},
                            "sharded_tensors": r0[part]["sharded_tensors"]}
        # (b): each rank holds a part of the state; the checkpoint is whole
        if r0["b"]["sharded_tensors"] == 0 or not all(
                r["b"]["state_bytes"] < r["b"]["unsharded_state_bytes"]
                for r, _ in ranks):
            raise AssertionError(f"(b) sharded nothing: {r0['b']}")
        fresh = get_family(cfg).build(cfg)[0].to(device)
        runner.load_checkpoint(os.path.join(tmp, "b_ckpt"), fresh)
        got = torch.load(os.path.join(tmp, "b_params.pt"))
        if not all(torch.equal(v.cpu(), got[k])
                   for k, v in fresh.state_dict().items()):
            raise AssertionError("(b): rank 0's checkpoint does not load "
                                 "into one process as the gathered "
                                 "parameters")
        result["b"].update(
            state_bytes={f"rank{r['rank']}": r["b"]["state_bytes"]
                         for r, _ in ranks},
            unsharded_state_bytes=r0["b"]["unsharded_state_bytes"],
            checkpoint_loads_into_one_process=True)
        # (c), (e), (f): the loss of every step
        for part in ("c", "e", "f"):
            for got, want in zip(result[part]["losses"],
                                 result[part]["one_process_losses"],
                                 strict=True):
                if not abs(got - want) <= SHARDING_LOSS_RTOL * abs(want):
                    raise AssertionError(
                        f"({part}): loss {got} against one process's {want}")
        result["f"]["neck_widths"] = r0["f"]["neck_widths"]
        # (c), (e): the split head's widths
        for part in ("c", "e"):
            for r, _ in ranks:
                if r[part]["neck_widths"] != SHARDING_NECK_WIDTHS \
                        or r[part]["head_columns"] != SHARDING_HEAD_COLUMNS:
                    raise AssertionError(
                        f"({part}) rank {r['rank']}: neck "
                        f"{r[part]['neck_widths']}, head columns "
                        f"{r[part]['head_columns']}")
            result[part].update(
                neck_widths=r0[part]["neck_widths"],
                head_columns={f"rank{r['rank']}": r[part]["head_columns"]
                              for r, _ in ranks},
                start_bytes={f"rank{r['rank']}": r[part]["start_bytes"]
                             for r, _ in ranks},
                peak_bytes={f"rank{r['rank']}": r[part]["peak_bytes"]
                            for r, _ in ranks},
                one_process_start_bytes=refs[part]["start_bytes"],
                one_process_peak_bytes=refs[part]["peak_bytes"],
                transients={f"rank{r['rank']}": r[part]["transients"]
                            for r, _ in ranks},
                one_process_transients=refs[part]["transients"],
                forward_flops={f"rank{r['rank']}": r[part]["forward_flops"]
                               for r, _ in ranks},
                one_process_forward_flops=refs[part]["forward_flops"])
        # (c): the two ranks' last labels joined are one process's
        det_cfg = get_family(cfg).build(cfg)[1]
        joined = torch.full_like(refs["c"]["labels"], -2)
        for r in range(2):
            part = parallel.head_part(
                det_cfg.featmap_sizes(),
                det_cfg.anchor_generator.num_base_anchors, 2, r)
            joined[:, part.indices] = torch.load(
                os.path.join(tmp, f"c_labels_rank{r}.pt"))
        if not torch.equal(joined, refs["c"]["labels"]):
            raise AssertionError(
                "(c): the ranks' labels differ from one process's at "
                f"{int((joined != refs['c']['labels']).sum())} anchors")
        result["c"]["labels_equal_one_process"] = True
        result["c"]["positives"] = int(
            (refs["c"]["labels"] < det_cfg.num_classes).sum())
        # (c): the predict of the partitioned model on whole images, and
        # the head's joined outputs, are one process's of the same weights
        result["c"]["predict"] = _predict_against_one_process(
            os.path.join(tmp, "c_predict.pt"),
            os.path.join(tmp, "c_params.pt"), device)
        # K1 on rank 0's last input of (c) and of (f)
        for part, what in (("c", "data 1 x space 2, the split head"),
                           ("f", "SSD, data 1 x space 2, the gathered "
                                 "head")):
            b1, b2 = torch.load(os.path.join(tmp,
                                             f"{part}_k1_input_rank0.pt"))
            checks.append({"input": f"sharding ({part}): rank 0's last "
                                    f"assignment input, {what}",
                           **check_kernel(KERNELS[0], b1.to(device),
                                          b2.to(device), reps,
                                          identical=False)})
    d = r0["d"]
    if d["shape"] != [ASSIGN_SHAPE[1], OVERLAP_BOXES] or not (
            d["within_tolerance"] and d["finite"]):
        raise AssertionError(f"(d): {d}")
    d["rank1_ms"] = r1["d"]["ms"]
    for c in checks:
        if not c["bitwise_equal"]:
            raise AssertionError(f"K1 differs from its plain version on "
                                 f"{c['input']}: {c['max_abs_err']}")
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "sharding_split_heads", "card": smi, **{
        name: {"config": os.path.relpath(config, ROOT),
               "head_columns": result[part]["head_columns"],
               "start_bytes": result[part]["start_bytes"],
               "peak_bytes": result[part]["peak_bytes"],
               "one_process_start_bytes":
                   result[part]["one_process_start_bytes"],
               "one_process_peak_bytes":
                   result[part]["one_process_peak_bytes"],
               "largest_forward_transients": result[part]["transients"],
               "one_process_largest_forward_transients":
                   result[part]["one_process_transients"],
               "forward_flops_batch1": result[part]["forward_flops"],
               "one_process_forward_flops_batch1":
                   result[part]["one_process_forward_flops"],
               "steady_step_ms": {k: v[-1] for k, v in
                                  result[part]["step_ms"].items()}}
        for name, part, config in (("c_retinanet", "c", CONFIG),
                                   ("e_fcos", "e", FCOS_CONFIG))}})
    emit({"phase": "sharding", "config": os.path.relpath(CONFIG, ROOT),
          "card": smi, "seconds": seconds, "a_world1_nccl_fsdp": a,
          "b_fsdp_two_gloo_ranks": result["b"],
          "c_space_two_gloo_ranks": result["c"],
          "d_sharded_overlaps": d,
          "e_fcos_space_two_gloo_ranks": result["e"],
          "f_ssd_space_two_gloo_ranks": result["f"],
          "kernel_launches": launches,
          "kernel_on_assignment_inputs": checks})
    return launches, checks


VIDEO_FRAMES = 24           # INPUT_SIZE panoramas, written as .avi and .mp4
VIDEO_FPS = 30.0
VIDEO_BATCH = 8             # video_demo's default: 3 predict calls of 8
VIDEO_MAX_FRAMES = 8        # the .mp4 run and the webcam run
VIDEO_CAMERA = 0            # /dev/video0: its refusal, or 8 frames from it
# An output frame against show_result's array for it, after one JPEG at
# quality 95 (4:2:0), on write_panoramas' smooth panoramas at 512x1024 with
# up to 100 outlines and labels drawn (100 seeded outlines: mean 10.5-11.7
# levels, PSNR 20.2-20.9 dB; 10: 1.8-2.0, 29.4-30.2 dB; on the CPU). Each
# frame is also held bit for bit to PIL's decode of PIL's JPEG of that
# array.
VIDEO_JPEG_TOLERANCE = {"mean": 16.0, "psnr_db": 18.0}


def _jpeg_gap(got: np.ndarray, want: np.ndarray) -> dict:
    diff = got.astype(np.float64) - want
    mse = float((diff ** 2).mean())
    return {"mean": float(np.abs(diff).mean()),
            "max": float(np.abs(diff).max()),
            "psnr_db": 10 * math.log10(255.0 ** 2 / mse) if mse else None}


def _host_parts(parts: dict, name: str, fn, frames_of=lambda *a: 1):
    """``fn`` that appends its milliseconds a frame to ``parts[name]``, the
    card synchronised; ``frames_of(*args)`` frames a call."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        n = frames_of(*args)
        parts.setdefault(name, []).extend(
            [(time.perf_counter() - t0) * 1e3 / n] * n)
        return out
    return wrapper


def phase_video(seed: int, reps: int, smi: str) -> tuple[int, dict]:
    """The video and webcam demos on the rotated config at full width:
    ``VIDEO_FRAMES`` panoramas at ``INPUT_SIZE`` written at ``VIDEO_FPS``
    by ``data/video.py:VideoWriter`` as ``.avi`` and as ``.mp4``; a
    checkpoint of seeded weights, the head calibrated on the first;
    ``video_demo.main`` on the ``.avi`` at ``--batch 8`` (3 predict calls)
    and on the ``.mp4`` with ``--max-frames 8``; ``webcam_demo.main
    --source`` the ``.avi`` ``--out DIR --max-frames 8``; ``--camera-id 0``:
    its ``cannot open camera 0`` exit where ``/dev/video0`` is missing, else
    8 frames from it. Gates: each output read back by ``open_video`` with
    the frame count, size (1024x512) and fps written; each output frame, and
    each webcam JPEG, bit for bit PIL's decode of PIL's JPEG of the
    ``show_result`` array recorded for it and within
    ``VIDEO_JPEG_TOLERANCE`` of that array; a box drawn; K1 once a frame
    (its counter zeroed before the demos), bitwise its plain version on the
    last NMS input. Host ms a frame: read and decode, predict, draw,
    encode. Returns K1's launches and its check."""
    from PIL import Image

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    cfg = load_config(CONFIG)
    seconds, parts = {}, {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        _, img_dir = write_panoramas(tmp, "video", VIDEO_FRAMES,
                                     cfg["model"]["num_classes"], seed)
        panoramas = [np.asarray(Image.open(os.path.join(img_dir, n))
                                .convert("RGB"))
                     for n in sorted(os.listdir(img_dir))]
        h, w = INPUT_SIZE
        inputs, containers = {}, {}
        for suffix in ("avi", "mp4"):
            inputs[suffix] = os.path.join(tmp, f"in.{suffix}")
            t0 = time.perf_counter()
            with video_io.VideoWriter(inputs[suffix], VIDEO_FPS,
                                      (w, h)) as writer:
                for frame in panoramas:
                    writer.write(frame)
            seconds[f"write_{suffix}"] = time.perf_counter() - t0
            with video_io.open_video(inputs[suffix]) as r:
                containers[suffix] = {
                    "bytes": os.path.getsize(inputs[suffix]),
                    "frames": r.frame_count, "size": list(r.size),
                    "fps": r.fps}
            if containers[suffix]["frames"] != VIDEO_FRAMES \
                    or r.size != (w, h) or r.fps != VIDEO_FPS:
                raise AssertionError(f"{suffix} written: {containers}")

        det = init_detector(CONFIG, seed=seed)
        det.model.load_state_dict(seeded_state_dict(det.model, seed))
        assert_full_width(det)
        head_std = calibrate_head(det, det.pipeline.resize(panoramas[0]))
        ckpts = os.path.join(tmp, "ckpts")
        runner.Checkpointer(ckpts).save(
            det.model, build_tx(cfg, det.model, steps_per_epoch=1), epoch=1)
        del det

        shown, nms_calls = [], []
        real = (video_cli.inference_detector, webcam_cli.inference_detector,
                video_cli.show_result, webcam_cli.show_result,
                video_io.decode_jpeg, video_io.encode_jpeg,
                nms_module.sph2pob_iou_pairwise)

        boxes_drawn = []

        def drawn(fn):
            def wrapper(det, img, result, score_thr=0.3, **kwargs):
                out = fn(det, img, result, score_thr=score_thr, **kwargs)
                shown.append(out.copy())
                boxes_drawn.append(sum(int((r[:, -1] >= score_thr).sum())
                                       for r in result))
                return out
            return wrapper

        predict = _host_parts(parts, "predict", real[0],
                              lambda det, imgs: len(imgs))
        draw = drawn(_host_parts(parts, "draw", real[2]))
        video_cli.inference_detector = predict
        webcam_cli.inference_detector = _host_parts(parts, "predict",
                                                    real[1])
        video_cli.show_result = webcam_cli.show_result = draw
        video_io.decode_jpeg = _host_parts(parts, "read_decode", real[4])
        video_io.encode_jpeg = _host_parts(parts, "encode", real[5])
        nms_module.sph2pob_iou_pairwise = _recording(
            sph2pob_iou_pairwise, nms_calls, keep_last=True)
        runs, said = {}, {}
        try:
            sph2pob_iou_pairwise.launches = 0
            for name, entry, argv, n in (
                    ("video_demo_avi", video_cli.main,
                     [inputs["avi"], CONFIG, ckpts, "--out",
                      os.path.join(tmp, "out.avi"), "--batch",
                      str(VIDEO_BATCH)], VIDEO_FRAMES),
                    ("video_demo_mp4", video_cli.main,
                     [inputs["mp4"], CONFIG, ckpts, "--out",
                      os.path.join(tmp, "out.mp4"), "--max-frames",
                      str(VIDEO_MAX_FRAMES)], VIDEO_MAX_FRAMES),
                    ("webcam_demo", webcam_cli.main,
                     [CONFIG, ckpts, "--source", inputs["avi"], "--out",
                      os.path.join(tmp, "shots"), "--max-frames",
                      str(VIDEO_MAX_FRAMES)], VIDEO_MAX_FRAMES)):
                before, first = sph2pob_iou_pairwise.launches, len(shown)
                said[name], t = _timed(lambda: _said(lambda: entry(argv)))
                torch.cuda.synchronize()
                runs[name] = {"frames": n, "seconds": t,
                              "frames_per_second": n / t,
                              "kernel_launches":
                              sph2pob_iou_pairwise.launches - before,
                              "shown": (first, len(shown))}
            camera = f"/dev/video{VIDEO_CAMERA}"
            shots0 = os.path.join(tmp, "camera")
            argv = [CONFIG, ckpts, "--camera-id", str(VIDEO_CAMERA), "--out",
                    shots0, "--max-frames", str(VIDEO_MAX_FRAMES)]
            if os.path.exists(camera):
                before = sph2pob_iou_pairwise.launches
                said["camera"] = _said(lambda: webcam_cli.main(argv))
                torch.cuda.synchronize()
                runs["camera"] = {"device": camera,
                                  "kernel_launches":
                                  sph2pob_iou_pairwise.launches - before}
            else:
                try:
                    webcam_cli.main(argv)
                except SystemExit as e:
                    said["camera"] = str(e)
                if said.get("camera") != f"cannot open camera {VIDEO_CAMERA}" \
                        or os.path.exists(shots0):
                    raise AssertionError(f"--camera-id {VIDEO_CAMERA} "
                                         f"without {camera}: "
                                         f"{said.get('camera')!r}")
                runs["camera"] = {"device": f"{camera} is missing",
                                  "exit": said["camera"]}
            launches = sph2pob_iou_pairwise.launches
        finally:
            (video_cli.inference_detector, webcam_cli.inference_detector,
             video_cli.show_result, webcam_cli.show_result,
             video_io.decode_jpeg, video_io.encode_jpeg,
             nms_module.sph2pob_iou_pairwise) = real

        # the outputs read back, each frame against its show_result array
        gaps, outputs = [], {}
        out_size = tuple(reversed(cfg["img_size"]))  # (1024, 512)
        for name, path in (("video_demo_avi", "out.avi"),
                           ("video_demo_mp4", "out.mp4")):
            first, last = runs[name]["shown"]
            with video_io.open_video(os.path.join(tmp, path)) as r:
                outputs[name] = {"frames": r.frame_count, "size": list(r.size),
                                 "fps": r.fps,
                                 "bytes": os.path.getsize(
                                     os.path.join(tmp, path))}
                frames = list(r)
            if (r.frame_count, r.size, r.fps) != (
                    runs[name]["frames"], out_size, VIDEO_FPS) \
                    or last - first != r.frame_count:
                raise AssertionError(f"{name}: {outputs[name]}, "
                                     f"{last - first} frames drawn")
            for got, want in zip(frames, shown[first:last]):
                gaps.append(_held_to_jpeg(got, want, name))
        first, last = runs["webcam_demo"]["shown"]
        names = sorted(os.listdir(os.path.join(tmp, "shots")))
        if names != [f"frame_{i:06d}.jpg"
                     for i in range(1, VIDEO_MAX_FRAMES + 1)] \
                or last - first != VIDEO_MAX_FRAMES:
            raise AssertionError(f"webcam_demo wrote {names}")
        for name, want in zip(names, shown[first:last]):
            got = np.asarray(Image.open(os.path.join(tmp, "shots", name)))
            gaps.append(_held_to_jpeg(got, want, f"webcam_demo {name}"))
        outputs["webcam_demo"] = {"files": len(names),
                                  "size": list(shown[first].shape)}
    expected = VIDEO_FRAMES + 2 * VIDEO_MAX_FRAMES + runs["camera"].get(
        "kernel_launches", 0)
    short = {k: r["kernel_launches"] for k, r in runs.items()
             if "frames" in r and r["kernel_launches"] != r["frames"]}
    if launches != expected or short:
        raise AssertionError(f"K1: {launches} launches, expected {expected} "
                             f"(one a frame); runs off: {short}")
    if not said["video_demo_avi"].endswith(
            f"\n{VIDEO_FRAMES} frames -> {os.path.join(tmp, 'out.avi')}\n"):
        raise AssertionError(f"video_demo said {said['video_demo_avi']!r}")
    if not sum(boxes_drawn):
        raise AssertionError("no box was drawn on any frame")
    (shapes, b1, b2), = nms_calls
    on_input = {"input": "video: the last NMS input of webcam_demo",
                **check_kernel(KERNELS[0], b1, b2, reps, identical=False)}
    if not on_input["bitwise_equal"] or shapes[1][1] != 5:
        raise AssertionError(f"K1 at {shapes} differs from its plain "
                             f"version by {on_input['max_abs_err']}")
    for r in runs.values():
        r.pop("shown", None)
    emit({"phase": "video", "config": os.path.relpath(CONFIG, ROOT),
          "input_size": list(INPUT_SIZE), "fps": VIDEO_FPS,
          "containers": containers, "runs": runs, "outputs": outputs,
          "head_std_before_calibration": head_std,
          "host_ms_a_frame_median": {k: statistics.median(v)
                                     for k, v in parts.items()},
          "host_ms_a_frame_max": {k: max(v) for k, v in parts.items()},
          "frames_timed": {k: len(v) for k, v in parts.items()},
          "boxes_drawn_a_frame": [min(boxes_drawn), max(boxes_drawn)],
          "jpeg_gap_worst": {
              "mean": max(g["mean"] for g in gaps),
              "max": max(g["max"] for g in gaps),
              "psnr_db": min((g["psnr_db"] for g in gaps
                              if g["psnr_db"] is not None), default=None)},
          "jpeg_tolerance": VIDEO_JPEG_TOLERANCE,
          "kernel_launches": launches, "kernel_on_nms_input": on_input,
          "nvidia_smi": smi, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches, on_input


def _held_to_jpeg(got: np.ndarray, shown: np.ndarray, what: str) -> dict:
    """A decoded output frame: bit for bit PIL's decode of PIL's JPEG of
    the ``show_result`` array, and within ``VIDEO_JPEG_TOLERANCE`` of it."""
    if not np.array_equal(got, video_io.decode_jpeg(
            video_io.encode_jpeg(shown))):
        raise AssertionError(f"{what}: not the JPEG of show_result's array")
    gap = _jpeg_gap(got, shown)
    if gap["mean"] > VIDEO_JPEG_TOLERANCE["mean"] or (
            gap["psnr_db"] or math.inf) < VIDEO_JPEG_TOLERANCE["psnr_db"]:
        raise AssertionError(f"{what}: {gap} from show_result's array")
    return gap


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
    p.add_argument("--study", action="store_true",
                   help="only the device and build lines and the full "
                        "sphere-bench study: the dataset written, the "
                        "RetinaNet l1 and ciou variants trained 24 epochs "
                        "and evaluated beside the published JAX study")
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
    if args.study:
        phase_study_full(args.seed, args.reps)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return 0
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
    trained, on_pretrained_assign = phase_pretrained(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    trained, on_parallel_inputs = phase_parallel(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    trained, on_robust_input = phase_robustness(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    trained, on_demo_input = phase_visualize(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    trained, on_measure_inputs = phase_measure(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    trained, on_study_inputs = phase_study(args.seed, args.reps)
    launches["sph2pob_iou_pairwise"] += trained
    trained, on_sharding_inputs = phase_sharding(args.seed, args.reps, smi)
    launches["sph2pob_iou_pairwise"] += trained
    trained, on_video_input = phase_video(args.seed, args.reps, smi)
    launches["sph2pob_iou_pairwise"] += trained
    # K1 on the inputs its paths gave it, beside its seeded shapes
    shapes["sph2pob_iou_pairwise"] += [on_nms_input, on_assign_input,
                                       on_iou_input, on_ssd_input,
                                       *on_frcnn_input, on_val_nms_input,
                                       on_input_assign, on_pretrained_assign,
                                       *on_parallel_inputs, on_robust_input,
                                       on_demo_input, *on_measure_inputs,
                                       *on_study_inputs, *on_sharding_inputs,
                                       on_video_input]
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

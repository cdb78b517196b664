#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --fmad-probe # also: the kernel built with FMA contraction

Drives the serving path of ``sph_retina_tpu_torch`` the way a user would —
``init_detector`` on the shipped rotated RetinaNet-R50-FPN config at full
width (47 classes, 512x1024, bf16, 5-dof boxes), the HTTP server on an
ephemeral local port, ``/ping`` and a few ``/predict`` requests — and holds
every CUDA kernel of that path against its plain PyTorch version on the card.

Phases, each printing one JSON line; any failure ends the run non-zero:

1. device   name, and name + power limit as nvidia-smi gives them
2. build    the kernel library from ``sph_retina_tpu_torch/csrc`` with nvcc
3. kernels  sph2pob_iou_pairwise vs its plain version at the serving, ragged
            and training shapes (max abs difference <= 1e-4, values finite
            and in [0, 1]), timed with CUDA events (median after warm-up)
4. serve    the server answers the requests through the kernel (its launch
            counter is set to 0 before and read after), the records are well
            formed, and swapping the plain version in keeps the same boxes;
   breakdown  where a steady request's time goes (events, host clock, profiler)
5. the kernels' summary line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``

Weights are random, made with numpy from ``--seed``; no number printed here
says anything about detection quality. Needs no network; exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sph_retina_tpu_torch.apis import inference_detector, init_detector
from sph_retina_tpu_torch.boxes import nms as nms_module
from sph_retina_tpu_torch.data.pipeline import maybe_normalize_images
from sph_retina_tpu_torch.ops import _build
from sph_retina_tpu_torch.ops.fused_iou import sph2pob_iou_pairwise_plain
from sph_retina_tpu_torch.ops.sph2pob_iou import sph2pob_iou_pairwise
from sph_retina_tpu_torch.serve import make_handler

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs",
                      "sph_rotated_retinanet_r50_fpn_120e_pandora.py")
KERNEL_NAME = "sph2pob_iou_pairwise"
KERNEL_SOURCE = "sph_retina_tpu_torch/csrc/sph2pob_iou.cu"
KERNEL_REPLACES = "sph_retina_tpu/ops/pallas_iou.py:134"
TOLERANCE = 1e-4  # the JAX suite's own tolerance for its Pallas kernel
# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and the fp32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# (N, M, D): serving (once per image), ragged edges, the training shape
SERVING_SHAPE = (1000, 1000, 5)
SHAPES = [SERVING_SHAPE, (1000, 1000, 4), (7, 5, 5), (129, 257, 4),
          (128, 98208, 4)]
N_REQUESTS = 5


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


def kernel_inputs(n: int, m: int, d: int, seed: int):
    """Two seeded box sets with degenerate pairs mixed in: bitwise-identical
    boxes on the leading diagonal and, where there is room, a grid of cells
    that touch along exact meridians and parallels on both sides."""
    rng = np.random.default_rng(seed)
    b1, b2 = seeded_boxes(n, d, rng), seeded_boxes(m, d, rng)
    k = max(1, min(n, m) // 8)
    b2[:k] = b1[:k]
    if min(n, m) >= k + 15:
        cells = np.array([[t, p, 30.0, 30.0] + [0.0] * (d - 4)
                          for t in np.arange(30.0, 180.0, 30.0)
                          for p in np.arange(45.0, 135.0, 30.0)], np.float32)
        b1[k:k + len(cells)] = cells
        b2[k:k + len(cells)] = cells
    return b1, b2


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Weights made with numpy from a seed: He-normal conv kernels, batch
    norms at identity except the last one of each residual block (scale 0.3,
    so that activations do not grow 2x a block), biases 0 — the focal prior
    of ``retina_cls`` included, or no score would pass ``score_thr``."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
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


class _PairOpCounter(TorchDispatchMode):
    """Counts the tensor operations whose result has one element a pair."""

    def __init__(self, numel: int):
        super().__init__()
        self.numel = numel
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.numel() == self.numel \
                and "zeros_like" not in str(func):
            self.count += 1
        return out


def ops_per_pair(d: int) -> int:
    """Elementwise fp32 operations (arithmetic, compare, select, sin/cos,
    sqrt, each counted once) that the plain version spends on one pair;
    operations on one side's boxes alone are not counted."""
    rng = np.random.default_rng(0)
    b1 = torch.from_numpy(seeded_boxes(6, d, rng))
    b2 = torch.from_numpy(seeded_boxes(7, d, rng))
    with _PairOpCounter(42) as counter:
        sph2pob_iou_pairwise_plain(b1, b2)
    return counter.count


def bound_ms(n: int, m: int, d: int) -> tuple[float, str, dict]:
    """The least time the card could take: the larger of bytes moved (each
    input read once, the output written once) over the memory rate and
    operations over the fp32 rate."""
    n_bytes = 4 * ((n + m) * d + n * m)
    n_ops = ops_per_pair(d) * n * m
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    detail = {"bytes": n_bytes, "operations": n_ops,
              "bytes_ms": by_bytes, "operations_ms": by_ops}
    return max(by_bytes, by_ops), \
        ("operations" if by_ops >= by_bytes else "bytes"), detail


def check_kernel_shape(n: int, m: int, d: int, seed: int, reps: int) -> dict:
    b1_np, b2_np = kernel_inputs(n, m, d, seed)
    b1 = torch.from_numpy(b1_np).cuda()
    b2 = torch.from_numpy(b2_np).cuda()
    got = sph2pob_iou_pairwise(b1, b2)
    torch.cuda.synchronize()
    want = sph2pob_iou_pairwise_plain(b1, b2)
    torch.cuda.synchronize()
    if tuple(got.shape) != (n, m) or got.dtype != torch.float32:
        raise AssertionError(f"kernel output {tuple(got.shape)} {got.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"non-finite IoU at shape {(n, m, d)}")
    lo, hi = float(got.min()), float(got.max())
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"IoU outside [0, 1] at {(n, m, d)}: {lo}, {hi}")
    k = max(1, min(n, m) // 8)
    ident = float(got.diagonal()[:k].min())
    if ident <= 0.9:  # boxes down to 1 degree wide, jittered by 0.007
        raise AssertionError(f"identical boxes give IoU {ident}")
    err = float((got - want).abs().max())
    if not err <= TOLERANCE:
        raise AssertionError(
            f"kernel differs from its plain version by {err} at {(n, m, d)}")
    del want
    ms = median_ms(lambda: sph2pob_iou_pairwise(b1, b2), reps)
    plain = median_ms(lambda: sph2pob_iou_pairwise_plain(b1, b2),
                      max(5, reps // 4) if n * m > 4_000_000 else reps,
                      warmup=1)
    bound, by, detail = bound_ms(n, m, d)
    return {"shape": [n, m, d], "max_abs_err": err,
            "bitwise_equal": err == 0.0, "min_identical_iou": ident,
            "kernel_ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, **detail}


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
        b1_np, b2_np = kernel_inputs(n, m, d, seed)
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
    path, seconds, log = _build.build_library("sph2pob_iou")
    emit({"phase": "build", "library": os.path.relpath(path, ROOT),
          "nvcc_seconds": seconds, "flags": list(_build.NVCC_FLAGS),
          "ptxas": [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]})


def phase_kernels(seed: int, reps: int) -> list[dict]:
    results = [check_kernel_shape(n, m, d, seed + i, reps)
               for i, (n, m, d) in enumerate(SHAPES)]
    emit({"phase": "kernels", "tolerance": TOLERANCE,
          "ops_per_pair": {"4": ops_per_pair(4), "5": ops_per_pair(5)},
          "shapes": results})
    return results


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


def phase_serve(seed: int):
    """Returns (the kernel's launches over the served requests, the
    detector, the images)."""
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
    handler = make_handler(det, classes, 0.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    request_ms, answers = [], []
    try:
        with urllib.request.urlopen(base + "/ping", timeout=60) as r:
            if r.status != 200 or json.load(r) != {"status": "ok"}:
                raise AssertionError("/ping failed")
        # as the server's main() does before it listens: one call in the
        # worker's thread, so that no request pays for that thread's set-up
        handler.worker.submit(inference_detector, det,
                              np.zeros((h, w, 3), np.uint8)).result()
        sph2pob_iou_pairwise.launches = 0
        for image in images:
            buf = io.BytesIO()
            np.save(buf, image)
            req = urllib.request.Request(
                base + "/predict", data=buf.getvalue(), method="POST",
                headers={"Content-Type": "application/x-npy"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                status, body = r.status, r.read()
            request_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"/predict answered {status}: {body!r}")
            answers.append(json.loads(body))
        launches = sph2pob_iou_pairwise.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        handler.worker.shutdown()
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")
    if launches < len(images):
        raise AssertionError(
            f"{launches} kernel launches over {len(images)} requests: the "
            "serving path did not go through the kernel")
    for records in answers:
        check_records(records, det)

    # the same images with the plain version in the kernel's place
    # (one image a call, as the server ran them: a batch of another size
    # takes other convolution code, and bf16 logits then differ)
    with_kernel = [inference_detector(det, im) for im in images]
    torch.cuda.synchronize()
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
          "request_ms": request_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return launches, det, images


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

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference_detector(det, image)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: operator rows repeat their kernels' time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(r[1] for r in rows)
    out["profiled_wall_ms"] = wall_us / 1e3
    out["profiled_device_ms"] = device_us / 1e3 if rows else None
    out["device_idle_share"] = 1.0 - device_us / wall_us if rows else None
    out["device_kernel_launches"] = sum(r[2] for r in rows)
    out["top_device_ms"] = [
        {"name": k[:60], "ms": us / 1e3, "calls": n}
        for k, us, n in sorted(rows, key=lambda r: -r[1])[:8]]
    iou = [us for k, us, _ in rows if "pairwise_kernel" in k]
    out["sph2pob_iou_kernel_ms_in_request"] = sum(iou) / 1e3 if iou else None
    emit(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20,
                   help="timed launches per kernel and shape (median)")
    p.add_argument("--fmad-probe", action="store_true",
                   help="also build the kernel with FMA contraction and "
                        "report its error and time beside the shipped build")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 1

    kind, smi = phase_device()
    phase_build()
    shapes = phase_kernels(args.seed, args.reps)
    if args.fmad_probe:
        emit({"phase": "fmad_probe", **fmad_probe(args.seed, args.reps)})
    launches, det, images = phase_serve(args.seed)
    phase_breakdown(det, images[-1], args.reps)

    main_shape = next(s for s in shapes if s["shape"] == list(SERVING_SHAPE))
    print(smi, flush=True)
    emit({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None, "shape": main_shape["shape"],
        "tolerance": TOLERANCE, "shapes": shapes}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

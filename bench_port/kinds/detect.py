"""Traffic of kind ``detect``: a closed loop of ``inference_detector`` on
batches of frames, driven by the benchmark.

Set-up builds the detector with ``init_detector`` and hands it the
benchmark's seeded weights, its two output convolutions calibrated so that
every frame keeps a full set of detections, and calls it once on every
batch of the pool. The window then calls it again and again, one batch
after another, each call timed from the frames handed over to the numpy
results. Once the window has closed and the detector is freed, the
reference detects a sample of the window's batches, drawn from the seed,
and judges the program's results on them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import judge, port, trace, traffic
from ..flops import model_flops
from ..reference import detector as ref_det
from ..reference.nets import Detector
from ..weights import calibrate, make_weights


def well_formed(results, n: int, num_classes: int, d: int) -> int:
    """Images of a call whose result is not a list of ``num_classes``
    finite (k, d + 1) arrays."""
    if not isinstance(results, list) or len(results) != n:
        return n
    bad = 0
    for per_class in results:
        ok = isinstance(per_class, list) and len(per_class) == num_classes \
            and all(isinstance(a, np.ndarray) and a.ndim == 2
                    and a.shape[1] == d + 1 and np.isfinite(a).all()
                    for a in per_class)
        bad += not ok
    return bad


def reference_detections(run, weights_cpu, batches: list,
                         quant=None) -> list:
    """The reference's ``kept`` and ``candidates`` of every frame of each
    batch of ``batches``, in order."""
    model = Detector(run.config["family"], run.config["num_classes"],
                     run.config["box_version"]).to(run.device)
    model.load_state_dict(weights_cpu)
    model.set_quant(quant)
    anchors = ref_det.level_anchors(run.config, run.device)
    out = []
    for frames in batches:
        x = torch.from_numpy(np.stack(frames)).to(run.device)
        out += ref_det.detect_batch(run.config, model, x, anchors,
                                    chunk=run.mix["reference_chunk"])
    return out


def as_results(dets: list, num_classes: int) -> list:
    """Reference detections in ``inference_detector``'s format."""
    out = []
    for d in dets:
        b, s, lab = d["kept"]
        out.append([np.concatenate([b[lab == c], s[lab == c, None]], 1)
                    for c in range(num_classes)])
    return out


def run_cell(run) -> dict:
    config, mix = run.config, run.mix
    parts = {"imports": time.perf_counter() - run.start}
    cfg = port.port_config(config)
    weights = make_weights(config, run.seed, run.device)
    pool = traffic.detect_pool(config, mix, run.seed)
    frame = torch.from_numpy(pool[0][0][None].copy()).to(run.device)
    with run.exact():
        calibrate(config, weights, frame)
    weights_cpu = {k: v.float().cpu() for k, v in weights.items()}
    det = port.build_detector(cfg, weights, run.device)
    del weights, frame
    run.free()
    run.synchronize()
    parts["build"] = time.perf_counter() - run.start - sum(parts.values())
    for frames in pool:
        port.detect(det, frames)
    run.synchronize()
    setup_s = time.perf_counter() - run.start
    parts["calls"] = setup_s - sum(parts.values())

    n, lat, kept = 0, [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        t = time.perf_counter()
        res = port.detect(det, pool[n % len(pool)])
        lat.append(time.perf_counter() - t)
        kept.append(res)
        n += 1
    window = time.perf_counter() - t0
    b = mix["batch"]
    failed = sum(well_formed(r, b, config["num_classes"],
                             config["box_version"]) for r in kept)
    out = {"attempted": n * b, "failed": failed, "setup_parts": parts,
           "e2e": {"setup_s": setup_s, "detect_img_s": n * b / window,
                   "detect_p95_ms": 1e3 * float(np.percentile(lat, 95))}}

    if run.trace:
        calls = mix["trace_calls"]
        it = iter(range(n, n + calls))
        events = trace.profile_calls(
            lambda: port.detect(det, pool[next(it) % len(pool)]), calls)
    out["memory_peak_bytes"] = run.memory_peak()
    if run.trace:
        out["trace"] = trace.summarize(events, calls)
        out["layer"] = {"kind": "detect", "steps": calls,
                        "flops_per_step": model_flops(config, b, False)}

    del det
    run.free()
    rng = np.random.default_rng([run.seed, 4])
    sample = sorted(rng.choice(n, size=min(n, mix["check_calls"]),
                               replace=False))
    results = [r for i in sample for r in kept[i]]
    with run.exact():
        refs = reference_detections(run, weights_cpu,
                                    [pool[i % len(pool)] for i in sample])
    out["numbers"] = judge.detect_numbers(results, refs,
                                          config["test"]["max_per_img"],
                                          run.device)
    return out

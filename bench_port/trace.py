"""The traced sub-window: ``torch.profiler`` over a few calls, reduced to
what the per-layer metrics read.

The device's busy time is the union of the intervals of its kernels, copies
and fills within the window (overlapping kernels count once), the launches
are the kernel events, and each idle gap of the device is named by what the
host was doing at its middle: the innermost host operation open then and the
one around it.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW = "bench_port.window"
TOP = 10
NAMED_GAPS = 500


def profile_calls(fn, n: int) -> dict:
    """``fn()`` ``n`` times under the profiler, between two synchronises;
    returns the trace's events (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    return events


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: dict, calls: int) -> dict:
    """The window's busy and idle time, launches, the device operations by
    time and the idle gaps by the host's activity. Times in seconds."""
    evs = [e for e in events.get("traceEvents", events)
           if isinstance(e, dict) and e.get("ph") == "X"]
    win = [e for e in evs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace has no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    clipped = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                             w1)) for e in dev]
    busy = _union([(s, e) for s, e in clipped if e > s])
    busy_us = sum(e - s for s, e in busy)

    by_name = collections.defaultdict(float)
    for e in kernels:
        by_name[e["name"]] += float(e["dur"])
    host = [e for e in evs if e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW]
    h_ts = np.array([float(h["ts"]) for h in host])
    h_end = h_ts + np.array([float(h["dur"]) for h in host])
    h_dur = h_end - h_ts

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s),
                  key=lambda g: g[0] - g[1])
    by_host = collections.defaultdict(float)
    for s, e in gaps[:NAMED_GAPS]:
        mid = (s + e) / 2
        open_ = np.flatnonzero((h_ts <= mid) & (h_end >= mid))
        open_ = open_[np.argsort(h_dur[open_], kind="stable")][:2]
        name = " < ".join(host[i]["name"][:60] for i in open_)
        by_host[name or "(no host op)"] += e - s
    rest = sum(e - s for s, e in gaps[NAMED_GAPS:])
    if rest:
        by_host[f"(the {len(gaps) - NAMED_GAPS} shorter gaps)"] += rest

    def top(d):
        return [[k[:100], v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "calls": calls,
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "launches": len(kernels),
        "kernel_s": {k: v / 1e6 for k, v in by_name.items()},
        "device_ops": top(by_name),
        "idle_gaps": top(by_host),
    }


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(v for k, v in summary["kernel_s"].items() if fragment in k)

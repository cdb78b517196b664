"""The frozen yardsticks: the FLOP counter, the K1 stage counts and
roofline, the box generator and traffic, the trace reduction, and the
benchmark's independence from JAX and from the port."""

from __future__ import annotations

import ast
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from bench_port import flops, k1, run, trace, traffic
from bench_port.boxes import generate_boxes

SOURCES = sorted(glob.glob(os.path.join(run.HERE, "**", "*.py"),
                           recursive=True))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_anywhere():
    for path in SOURCES:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(run.FORBIDDEN), (path, tops)


def test_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(run.HERE, "reference", "*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "sph_retina_tpu_torch" not in tops, path


def test_only_port_module_imports_the_port():
    users = [os.path.relpath(p, run.HERE) for p in SOURCES
             if "sph_retina_tpu_torch" in {m.split(".")[0]
                                           for m in _imports(p)}]
    assert users == ["port.py"]


def test_flops_hand_count():
    net = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
                        nn.Flatten(), nn.Linear(8 * 8 * 8, 10))
    with torch.device("meta"):
        net = net.to("meta")
        x = torch.empty(2, 3, 8, 8)
    # each spatial axis: 8 outputs x 3 taps less the 2 padding taps
    taps = (8 * 3 - 2) ** 2
    conv = 2 * 2 * 8 * 3 * taps
    dense = 2 * 2 * 512 * 10
    assert flops.count_products(net, x) == conv + dense

    def step():
        net(x).sum().backward()

    # backward: the conv's weight gradient only (x needs none), the dense
    # layer's input and weight gradients
    assert flops.count_products(step) == 2 * conv + 3 * dense


def test_model_flops_are_counted_on_meta():
    cfg = run.load_json(run.HERE, "configs", "rretina_r50_pandora.json")
    fwd = flops.model_flops(cfg, 1, backward=False)
    assert 2.2e11 < fwd < 2.3e11  # the forward's 225 GFLOPs of products
    assert flops.model_flops(cfg, 2, backward=False) == 2 * fwd


@pytest.mark.parametrize("d", [4, 5])
def test_frozen_k1_counts(d):
    assert k1.count_stage_ops(d) == k1.STAGE_OPS[d]


def test_k1_bound():
    b = k1.bound_seconds(240, 98208, 5, 0)
    ops = k1.STAGE_OPS[5]
    pairs = 240 * 98208
    assert b["operations"] == 2 * (240 * 37 + 98208 * 37) + (
        ops["flag"] + ops["cull"] + ops["body"]) * pairs
    assert b["bytes"] == 4 * ((240 + 98208) * 5 + pairs)
    assert b["seconds"] == max(b["operations"] / 67e12, b["bytes"] / 3.35e12)
    assert k1.bound_seconds(240, 98208, 5, pairs)["seconds"] < b["seconds"]


def test_generate_boxes_is_frozen():
    got = generate_boxes(3, 5, seed=0)
    rng = np.random.default_rng(0)
    want = np.concatenate([rng.uniform(0, 360, (3, 1)),
                           rng.uniform(0, 180, (3, 1)),
                           rng.uniform(1, 100, (3, 1)),
                           rng.uniform(1, 100, (3, 1)),
                           rng.uniform(-90, 90, (3, 1))], 1)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_traffic_is_seeded_and_keeps_the_work():
    mix = run.load_json(run.HERE, "traffic", "train_b64.json")
    a = traffic.gt_counts(mix, 128, np.random.default_rng(1))
    b = traffic.gt_counts(mix, 128, np.random.default_rng(2))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert a.min() == 1 and 60 <= a.max() <= 64
    cfg = run.load_json(run.HERE, "configs", "rretina_r50_pandora.json")
    cfg.update(img_size=[16, 32], max_gt=64)
    mix.update(batch=2, pool=2)
    big = 2 ** 33 + 5  # wider than 32 signed bits
    p1 = traffic.train_pool(cfg, mix, big, "cpu")
    p2 = traffic.train_pool(cfg, mix, big, "cpu")
    for x, y in zip(p1, p2):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(p1[0]["images"], p1[1]["images"])
    f1 = traffic.detect_pool(cfg, dict(mix, kind="detect"), big)
    f2 = traffic.detect_pool(cfg, dict(mix, kind="detect"), big)
    assert all(np.array_equal(a, b) for x, y in zip(f1, f2)
               for a, b in zip(x, y))


def test_trace_summary():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "pairwise_kernel(x)",
         "ts": 60, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90,
         "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 41,
         "dur": 18},
        {"ph": "X", "cat": "cpu_op", "name": "step", "ts": 0, "dur": 100},
    ]
    s = trace.summarize({"traceEvents": ev}, calls=2)
    assert s["window_s"] == pytest.approx(100e-6)
    # kernels 10-40 (overlapping once), 60-70, the copy up to the window's
    # end 90-100
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["launches"] == 3
    assert trace.kernel_seconds(s, "pairwise_kernel") == pytest.approx(10e-6)
    assert s["device_ops"][0] == ["gemm", pytest.approx(40e-6)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps["aten::item < step"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(50e-6)


def test_benchmark_file_fits_the_contract():
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for c in bench["configs"]:
        json.loads(open(os.path.join(run.ROOT, c["file"])).read())
        assert c["reduced"] == []
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(run.HERE, "cells",
                                           f"{w['name']}.json"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(run.HERE, "metrics",
                                           f"{m['name']}.py"))
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}

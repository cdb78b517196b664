"""Tests of the port's benchmark, on the CPU at a tiny size.

    python -m pytest bench_port/tests -q

``tiny`` runs the harness's own ``main`` with its look for a CUDA device
replaced, every cell cut to 64x128 images, two a batch, the port in
float32. Tests marked ``card`` need a CUDA device and skip without one.
"""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import port, run  # noqa: E402

TINY_CONFIG = {"img_size": [64, 128], "max_gt": 8}
TINY_MIX = {"batch": 2, "pool": 3, "check_calls": 1, "trace_calls": 2,
            "trace_steps": 2, "reference_chunk": 2}
TINY_PORT = {"img_size": (64, 128), "data": {"max_gt": 8}, "bf16": False}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


def shrink(parts, data):
    kind = os.path.basename(os.path.dirname(os.path.join(*parts)))
    if kind == "configs":
        data.update(TINY_CONFIG)
    elif kind == "traffic":
        data.update(TINY_MIX)
        if "gt_per_image" in data:
            data["gt_per_image"]["max"] = TINY_CONFIG["max_gt"]
    return data


@pytest.fixture
def tiny(monkeypatch, capsys):
    """``tiny(workload, trace=0, seed=5) -> (exit code, result line or None,
    standard error)``: a run of the harness at the tiny size on the CPU."""
    import torch

    load = run.load_json
    monkeypatch.setattr(run, "load_json",
                        lambda *parts: shrink(parts, load(*parts)))
    monkeypatch.setattr(run, "find_device", lambda chips: torch.device("cpu"))
    monkeypatch.setattr(run, "device_fields", lambda device, chips: {
        "platform": "cpu", "kind": "cpu", "count": chips})
    port_config = port.port_config
    monkeypatch.setattr(port, "port_config", lambda config, overrides=None:
                        port_config(config, {**TINY_PORT,
                                             **(overrides or {})}))

    def call(workload, trace=0, seed=5):
        capsys.readouterr()
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.5", "--trace", str(trace)])
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if rc == 0 else None), err

    return call


@pytest.fixture
def cuda():
    """Skips the test without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

"""The harness end to end at the tiny size: the result line, the checks, the
faults and the control that ``correct`` has to refuse, and a cell added as
files alone."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from bench_port import calibrate, port, run

CELLS = [w["name"] for w in run.load_json(run.ROOT, "BENCHMARK.json")
         ["workloads"]]
TRAIN = [c for c in CELLS if ".train_" in c]
DETECT = [c for c in CELLS if c.endswith(".detect_b16")]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(tiny, cell, trace):
    rc, line, err = tiny(cell, trace)
    assert rc == 0, err
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) and all(
        c["value"] <= c["limit"] for c in line["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check ")
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    if not trace:
        want = {m["name"] for m in run.cell_metrics(bench, cell,
                                                   "end_to_end", ())}
        assert set(line["metrics"]) == want
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        # the CPU has no device trace: only the host clock's metrics read
        e2e = {m["name"] for m in run.cell_metrics(bench, cell, "end_to_end",
                                                   ())}
        host = {m["name"] for m in run.cell_metrics(bench, cell, "per_layer",
                                                    e2e)
                if m["source"] == "host_clock"}
        assert set(line["metrics"]) == host
        assert line["device"]["busy_s"] == 0.0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert run.forbidden_modules() == []


def _broken_train(monkeypatch, fault):
    build = port.build_train_step

    def broken(*args, **kw):
        model, optimizer, step = build(*args, **kw)
        if fault == "unchanged":
            optimizer.step = lambda: None
            return model, optimizer, step
        if fault == "half_batch":
            return model, optimizer, lambda b: step(calibrate.half(b))
        update = optimizer.step

        @torch.no_grad()
        def altered():  # each step's change half again too large
            before = [p.clone() for p in optimizer.params]
            update()
            for p, b in zip(optimizer.params, before):
                p.add_(p - b, alpha=0.5)

        optimizer.step = altered
        return model, optimizer, step

    monkeypatch.setattr(port, "build_train_step", broken)


def _broken_detect(monkeypatch, fault):
    detect = port.detect

    def broken(det, frames):
        res = detect(det, frames)
        half = len(res) // 2
        if fault == "half_batch":
            return res[:half] + [[a[:0] for a in r] for r in res[half:]]
        out = []
        for r in res:  # each image's best detection moved to another class
            r = [a.copy() for a in r]
            c = max(range(len(r)), key=lambda i: r[i][:, -1].max(initial=-1))
            best = int(np.argmax(r[c][:, -1]))
            r[(c + 1) % len(r)] = np.concatenate([r[(c + 1) % len(r)],
                                                  r[c][best:best + 1]])
            r[c] = np.delete(r[c], best, axis=0)
            out.append(r)
        return out

    monkeypatch.setattr(port, "detect", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_faults_fail(tiny, monkeypatch, cell, fault):
    _broken_train(monkeypatch, fault)
    rc, line, err = tiny(cell)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("cell", DETECT)
def test_detect_faults_fail(tiny, monkeypatch, cell, fault):
    _broken_detect(monkeypatch, fault)
    rc, line, err = tiny(cell)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny, cell):
    """The reference with float8 convolutions in the program's place
    breaks a limit of the cell (readings as ``bench_port.calibrate`` takes
    them, at the tiny size)."""
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    w = run.find_cell(bench, cell)
    config = run.load_json(run.HERE, "configs", f"{w['config']}.json")
    mix = run.load_json(run.HERE, "traffic", f"{w['traffic']}.json")
    limits = run.load_json(run.HERE, "cells", f"{cell}.json")["limits"]
    args = type("Args", (), {"seed": 7, "seconds": 0.0, "trace": 0})
    r = run.make_run(config, mix, args, torch.device("cpu"))
    fn = calibrate.train_seed if mix["kind"] == "train" \
        else calibrate.detect_seed
    readings = fn(r)
    from bench_port import judge

    assert judge.decide(readings["program"], limits)[0]
    assert not judge.decide(readings["control"], limits)[0]
    assert not judge.decide(readings["half_batch"], limits)[0]


def test_no_device_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run, "find_device", lambda chips: None)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


def test_added_files_need_no_edit(tiny, monkeypatch, tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as new files and entries are found by name."""
    here = tmp_path / "bench_port"
    for d in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(os.path.join(run.HERE, d), here / d)
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    cfg = run.load_json(run.HERE, "configs", "rretina_r50_pandora.json")
    cfg["name"] = "rretina_r50_pandora_copy"
    (here / "configs" / "rretina_r50_pandora_copy.json").write_text(
        json.dumps(cfg))
    mix = run.load_json(run.HERE, "traffic", "train_b64.json")
    mix["gt_per_image"]["min"] = 4
    (here / "traffic" / "train_dense.json").write_text(json.dumps(mix))
    (here / "metrics" / "traced_steps.train.py").write_text(
        "def read(ctx):\n    return float(ctx['layer']['steps'])\n")
    name = "rretina_r50_pandora_copy.train_dense"
    shutil.copy(here / "cells" / "rretina_r50_pandora.train_b64.json",
                here / "cells" / f"{name}.json")
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": "bench_port/configs/x.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": "train_dense", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append(name)
    bench["per_layer"].append({
        "name": "traced_steps.train", "unit": "steps", "better": "higher",
        "source": "device_trace", "layer": "trainer step",
        "moves": "train_img_s", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    monkeypatch.setattr(run, "HERE", str(here))
    rc, line, err = tiny(name, trace=1)
    assert rc == 0, err
    assert line["metrics"] == {"traced_steps.train": {"value": 2.0,
                                                      "unit": "steps"}}
    rc, line, err = tiny(name, trace=0)
    assert set(line["metrics"]) == {"setup_s", "train_img_s"}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cuda, cell):
    """A short run of the cell as the check runs it, at its own size."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"

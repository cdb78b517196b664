"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix and limits are found by name under
``bench_port/configs/``, ``bench_port/traffic/`` and ``bench_port/cells/``,
each per-layer metric's reader under ``bench_port/metrics/``. The traffic
mix's ``kind`` names the driver (``bench_port/kinds/<kind>.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error. Without a CUDA device, with fewer than the
cell asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sph_retina_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(ROOT, "build", "bench_port")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are "
                     f"{[w['name'] for w in bench['workloads']]}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, section: str, reports) -> list:
    """The entries of ``section`` that the cell reports: those that list it,
    and those without a list whose ``moves`` the cell reports."""
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in reports:
            out.append(m)
    return out


def read_metric(name: str, ctx: dict):
    """The per-layer metric's reader, ``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's products, restored after."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def power_limit() -> str | None:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else None


def make_run(config, mix, args, device) -> SimpleNamespace:
    import torch

    cuda = device.type == "cuda"

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    return SimpleNamespace(
        config=config, mix=mix, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=device, start=START,
        synchronize=torch.cuda.synchronize if cuda else (lambda: None),
        memory_peak=(torch.cuda.max_memory_allocated if cuda
                     else (lambda: 0)),
        free=free, exact=float32_exact)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def evaluate(bench: dict, cell: dict, out: dict, limits: dict,
             trace: bool) -> dict:
    """The result line of a run's output (``kinds.<kind>.run_cell``)."""
    from . import judge

    correct, checks = judge.decide(out["numbers"], limits)
    correct = correct and out["failed"] == 0
    e2e = cell_metrics(bench, cell["name"], "end_to_end", ())
    if not trace:
        # ``<quantity>.<qualifier>`` is the quantity, in the cells it lists
        metrics = {m["name"]: {"value": out["e2e"][m["name"].split(".")[0]],
                               "unit": m["unit"]} for m in e2e}
    else:
        ctx = {"cell": cell["name"], "trace": out["trace"],
               "layer": out["layer"], "e2e": out["e2e"]}
        metrics = {}
        for m in cell_metrics(bench, cell["name"], "per_layer",
                              {m["name"] for m in e2e}):
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics}
    line["device"] = {"memory_peak_bytes": out["memory_peak_bytes"]}
    if trace:
        line["device"].update(busy_s=out["trace"]["busy_s"],
                              window_s=out["trace"]["window_s"])
        line["breakdown"] = {"device_ops": out["trace"]["device_ops"],
                             "idle_gaps": out["trace"]["idle_gaps"]}
    line["checks"] = checks
    return line


def find_device(chips: int):
    """The first CUDA device, or None where the machine has fewer than
    ``chips``."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return device


def device_fields(device, chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "power_limit": power_limit()}


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    mix = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    limits = load_json(HERE, "cells", f"{cell['name']}.json")["limits"]
    cache_dirs()
    device = find_device(cell["chips"])
    if device is None:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s), which "
              f"this machine does not have", file=sys.stderr)
        return 2
    kind = importlib.import_module(f"bench_port.kinds.{mix['kind']}")
    out = kind.run_cell(make_run(config, mix, args, device))

    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    line = evaluate(bench, cell, out, limits, bool(args.trace))
    line["device"] = {**device_fields(device, cell["chips"]),
                      **line["device"]}
    print("set-up seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["setup_parts"].items()),
        file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

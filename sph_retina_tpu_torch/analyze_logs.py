"""Training-log analysis of the JSONL metric log the trainer writes.

    python -m sph_retina_tpu_torch.analyze_logs plot_curve \\
        work_dirs/run/metrics.jsonl --keys loss loss_cls --out curves.png
    python -m sph_retina_tpu_torch.analyze_logs cal_train_time \\
        work_dirs/run/metrics.jsonl

``plot_curve`` draws each key's ``train`` records against the step (any
prefix's where ``train`` has none) through ``visualize/plots.py``;
``cal_train_time`` prints the epochs' count and mean, fastest and slowest
``epoch_time``. Host only.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .visualize.plots import plot_curve as _plot


def load_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def plot_curve(records, keys, out):
    """One curve a key; keys of different steps share the union of them,
    a key missing at a step left out of its curve."""
    curves = {}
    for key in keys:
        xs = [r["step"] for r in records if key in r and r["prefix"] == "train"]
        ys = [r[key] for r in records if key in r and r["prefix"] == "train"]
        if not xs:
            xs = [r["step"] for r in records if key in r]
            ys = [r[key] for r in records if key in r]
        curves[key] = (xs, ys)
    steps = sorted({x for xs, _ in curves.values() for x in xs})
    _plot(steps, {key: [dict(zip(xs, ys)).get(s, np.nan) for s in steps]
                  for key, (xs, ys) in curves.items()},
          xlabel="step", ylabel="", out_file=out)
    print(f"saved {out}")


def cal_train_time(records):
    times = [r["epoch_time"] for r in records if r.get("prefix") == "epoch"]
    if not times:
        print("no epoch records")
        return
    print(f"epochs: {len(times)}  mean: {np.mean(times):.2f}s  "
          f"fastest: {min(times):.2f}s  slowest: {max(times):.2f}s")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Training-log analysis")
    p.add_argument("task", choices=["plot_curve", "cal_train_time"])
    p.add_argument("log")
    p.add_argument("--keys", nargs="*", default=["loss"])
    p.add_argument("--out", default="curves.png")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    records = load_log(args.log)
    if args.task == "plot_curve":
        plot_curve(records, args.keys, args.out)
    else:
        cal_train_time(records)
    return 0


if __name__ == "__main__":
    sys.exit(main())

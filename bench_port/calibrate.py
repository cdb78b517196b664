"""The readings that the limits of a cell are set from: the program's
numbers on many seeds, and those of the lower-precision control and of a
planted fault, in one process.

    python3 -m bench_port.calibrate --workload <cell> --seeds 1 2 3 ... \\
        [--out chiprun_out/calibrate.jsonl]

Each seed goes through the same set-up and the same calls as a run of the
cell (no measured window: the readings need none), then:

- ``program``: the port's numbers against the float32 reference;
- ``control``: the reference computed with float8 (e4m3) convolutions, put
  in the program's place (the configurations state bfloat16);
- ``half_batch``: the port fed the first half of each batch only, so that
  its losses are means over the rest (training), or returning nothing for
  the second half of the frames (detection).

One JSON line a seed; the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import judge, port, run as bench_run, traffic
from .kinds import detect, train
from .reference.nets import fp8
from .weights import calibrate, make_weights


def half(batch: dict) -> dict:
    n = batch["images"].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def train_seed(run) -> dict:
    config, mix = run.config, run.mix
    cfg = port.port_config(config)
    readings = {}
    for name, feed in (("program", lambda b: b), ("half_batch", half)):
        weights = make_weights(config, run.seed, run.device)
        weights_cpu = train._cpu(weights)
        model, optimizer, step = port.build_train_step(
            cfg, weights, run.device, run.seed)
        del weights
        pool = traffic.train_pool(config, mix, run.seed, run.device)
        check = pool[:mix["check_steps"]]
        readings[name] = train.checked_steps(
            run, model, optimizer, lambda b: step(feed(b)), check,
            weights_cpu)
        del model, optimizer, step, pool
        run.free()
    with run.exact():
        ref = train.reference_steps(run, weights_cpu, check)
        readings["control"] = train.reference_steps(run, weights_cpu, check,
                                                    quant=fp8)
    out = {k: judge.train_numbers(v, ref) for k, v in readings.items()}
    out["look"] = {
        "ref_losses": ref["losses"], "ref_grad_norms": ref["grad_norms"],
        **{f"{who}_losses": readings[who]["losses"] for who in readings},
        **{f"{who}_{key}": judge.worst_leaves(readings[who], ref, key)
           for who in ("program", "control") for key in ("grad", "delta")}}
    return out


def detect_seed(run) -> dict:
    config, mix = run.config, run.mix
    cfg = port.port_config(config)
    weights = make_weights(config, run.seed, run.device)
    pool = traffic.detect_pool(config, mix, run.seed)
    frame = torch.from_numpy(pool[0][0][None].copy()).to(run.device)
    with run.exact():
        calibrate(config, weights, frame)
    weights_cpu = {k: v.float().cpu() for k, v in weights.items()}
    det = port.build_detector(cfg, weights, run.device)
    del weights, frame
    for frames in pool:
        port.detect(det, frames)
    batches = pool[:mix["check_calls"]]
    results = [r for frames in batches for r in port.detect(det, frames)]
    del det
    run.free()
    b = mix["batch"]
    empty = [np.zeros((0, config["box_version"] + 1), np.float32)] \
        * config["num_classes"]
    halved = [r if i % b < b // 2 else empty for i, r in enumerate(results)]
    with run.exact():
        refs = detect.reference_detections(run, weights_cpu, batches)
        ctl = detect.reference_detections(run, weights_cpu, batches,
                                          quant=fp8)
    m = config["test"]["max_per_img"]
    kept = sum(len(judge._split(r)[1]) for r in results) / len(results)
    return {"program": judge.detect_numbers(results, refs, m, run.device),
            "control": judge.detect_numbers(
                detect.as_results(ctl, config["num_classes"]), refs, m,
                run.device),
            "half_batch": judge.detect_numbers(halved, refs, m, run.device),
            "kept_per_image": kept}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench = bench_run.load_json(bench_run.ROOT, "BENCHMARK.json")
    cell = bench_run.find_cell(bench, args.workload)
    config = bench_run.load_json(bench_run.HERE, "configs",
                                 f"{cell['config']}.json")
    mix = bench_run.load_json(bench_run.HERE, "traffic",
                              f"{cell['traffic']}.json")
    bench_run.cache_dirs()
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    fn = train_seed if mix["kind"] == "train" else detect_seed
    sink = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        ns = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
        line = {"workload": cell["name"], "seed": seed,
                **fn(bench_run.make_run(config, mix, ns, device)),
                "seconds": time.perf_counter() - t0,
                "device": torch.cuda.get_device_name(0),
                "power_limit": bench_run.power_limit()}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

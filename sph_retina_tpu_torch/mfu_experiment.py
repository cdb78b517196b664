"""Model-FLOP utilisation of the RetinaNet-R50 train step.

    python -m sph_retina_tpu_torch.mfu_experiment [--out mfu.json] \\
        [--experiments baseline] [--timeout 900] [--device cuda|cpu]

Each experiment runs in a fresh child process (``--child``), which prints
one ``CHILD_RESULT {json}`` line: the train step of
``configs/_base_/sph_retinanet_r50_fpn.py`` at batch 8, 512x1024, 16 GT
boxes an image (8 valid), its ``step_ms`` as the median of positive
marginals between runs of 12 and 2 steps (each ended by a
synchronisation), ``imgs_per_sec``, the FLOPs of one step
(``get_flops.count_flops`` over a step: the convolutions and dense products
of the forward pass and of the backward pass, input and weight gradients
where grad is required), and on the card ``mfu`` = FLOPs / step seconds /
989e12 (one H100's dense bf16 peak, NVIDIA's data sheet, SXM, 700 W) with
the card's name and power limit. The parent writes every child's result,
with ``delta_vs_baseline_pct``, to ``--out``, and exits non-zero if a child
failed.

The JAX tool's other three experiments set options of XLA's TPU compiler
(``xla_tpu_*``); eager PyTorch has no counterpart, so only ``baseline``
exists.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "_base_", "sph_retinanet_r50_fpn.py")
EXPERIMENTS = {"baseline": None}
H100_PEAK_BF16_FLOPS = 989e12


def _card(device) -> dict:
    """The card's name and power limit (W) as nvidia-smi gives them."""
    import torch

    index = torch.cuda.current_device() if device.index is None \
        else device.index
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.rsplit(",", 1))
    return {"gpu": name, "power_limit_w": float(limit)}


def child(batch=8, h=512, w=1024, max_gt=16, device=None,
          save_iou_input=None) -> dict:
    """One experiment in this process; prints and returns its result.
    ``save_iou_input``: a path where the step's anchor-assignment IoU input
    (the two box sets of the pairwise kernel's launch) is saved."""
    import numpy as np
    import torch

    from .engine.builder import build_tx
    from .engine.train import make_train_step
    from .engine.zoo import get_family
    from .geometry import generate_boxes
    from .get_flops import count_flops
    from .models import single_stage
    from .utils.config import load_config
    from .utils.device import resolve_device, synchronize

    device = resolve_device(device)
    cfg = load_config(CONFIG)
    cfg["img_size"] = (h, w)
    nc = cfg["model"]["num_classes"]
    model, det_cfg = get_family(cfg).build(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device)
    optimizer = build_tx(cfg, model, 100)
    step = make_train_step(model, det_cfg, optimizer, single_stage.retina_loss)
    gen = torch.Generator(device=device).manual_seed(0)
    boxes = np.stack([generate_boxes(max_gt, 4, seed=i) for i in range(batch)])
    labels = np.tile(np.arange(max_gt) % nc, (batch, 1)).astype(np.int32)
    train_batch = {
        "images": torch.randn((batch, h, w, 3), generator=gen, device=device),
        "gt_boxes": torch.from_numpy(boxes).to(device),
        "gt_labels": torch.from_numpy(labels).to(device),
        "gt_mask": torch.from_numpy(
            np.tile(np.arange(max_gt) < max_gt // 2, (batch, 1))).to(device),
    }

    # the counted step is also the warm-up; every step has the same input
    real, calls = single_stage.sph2pob_iou_pairwise, []
    if save_iou_input:
        def recording(boxes1, boxes2):
            calls[:] = [(boxes1.clone(), boxes2.clone())]
            return real(boxes1, boxes2)
        single_stage.sph2pob_iou_pairwise = recording
    try:
        flops = count_flops(step, train_batch).products
    finally:
        single_stage.sph2pob_iou_pairwise = real
    if save_iou_input:
        torch.save(calls[-1], save_iou_input)
    step(train_batch)
    synchronize(device)

    def timed(n):
        t0 = time.perf_counter()
        for _ in range(n):
            step(train_batch)
        synchronize(device)
        return time.perf_counter() - t0

    ests, tries = [], 0
    while len(ests) < 3 and tries < 9:
        tries += 1
        ts, tl = timed(2), timed(12)
        est = (tl - ts) / 10
        if est > 0:
            ests.append(est)
    if not ests:
        raise RuntimeError("no positive marginal step time in 9 tries")
    per_step = statistics.median(ests)

    out = {"step_ms": round(per_step * 1e3, 2),
           "imgs_per_sec": round(batch / per_step, 1),
           "flops_per_step": flops}
    if device.type == "cuda":
        out["mfu"] = flops / per_step / H100_PEAK_BF16_FLOPS
        out.update(_card(device))
    print("CHILD_RESULT " + json.dumps(out), flush=True)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="work_dirs/torch_mfu_experiments.json")
    p.add_argument("--experiments", nargs="*", default=list(EXPERIMENTS),
                   choices=list(EXPERIMENTS))
    p.add_argument("--timeout", type=float, default=900)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: the CUDA device")
    p.add_argument("--save-iou-input", default=None,
                   help="each child saves its step's anchor-assignment IoU "
                        "input (torch.save of the two box sets) here")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.child:
        child(device=args.device, save_iou_input=args.save_iou_input)
        return 0
    results = {}
    for name in args.experiments:
        cmd = [sys.executable, "-m", "sph_retina_tpu_torch.mfu_experiment",
               "--child"]
        if args.device:
            cmd += ["--device", args.device]
        if args.save_iou_input:
            cmd += ["--save-iou-input", args.save_iou_input]
        print(f"=== {name}: options={EXPERIMENTS[name]}", flush=True)
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT,
                                  timeout=args.timeout, cwd=REPO)
            lines = proc.stdout.decode().splitlines()
            line = next((x for x in lines[::-1]
                         if x.startswith("CHILD_RESULT ")), None)
            if proc.returncode == 0 and line:
                results[name] = json.loads(line[len("CHILD_RESULT "):])
            else:
                results[name] = {"error": f"rc={proc.returncode}: "
                                 + " | ".join(lines[-3:])[:300]}
        except subprocess.TimeoutExpired:
            results[name] = {"error": f"timeout {args.timeout}s"}
        print(f"    {results[name]}", flush=True)

    if "step_ms" in results.get("baseline", {}):
        base = results["baseline"]["step_ms"]
        for r in results.values():
            if "step_ms" in r:
                r["delta_vs_baseline_pct"] = round(
                    100.0 * (r["step_ms"] - base) / base, 2)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    return 1 if any("error" in r for r in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())

"""Traffic of kind ``train``: the port's train step, driven by the
benchmark.

Set-up builds one step object (model, optimiser state, step function) as
the port's trainer does, with the benchmark's seeded weights; drives it
through its first steps on the pool's distinct batches (the first
``check_steps`` of them followed by the reference) and once over the rest
of the pool; then hands that same object to the window, which cycles
through the pool until ``--seconds`` have passed. Once the window has
closed and the program's state is freed, the reference repeats the checked
steps from the same weights and batches.
"""

from __future__ import annotations

import time

import torch

from .. import judge, k1, port, trace, traffic
from ..flops import model_flops
from ..reference import detector as ref_det
from ..reference.nets import Detector
from ..reference.sph2pob_iou import pairwise_disjoint
from ..weights import make_weights

# the assignment backend of the port's configuration files that runs K1
K1_BACKEND = "sph2pob_efficient"


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().float().cpu() for k, v in tensors.items()}


def checked_steps(run, model, optimizer, step, pool, p0) -> dict:
    """The first ``check_steps`` steps through the window's own call: each
    step's losses (the total and each term), the first step's clipped
    gradient (its momentum buffer less the weight decay's share) and the
    change of the parameters."""
    wd = run.config["optimizer"]["weight_decay"]
    losses, grad = [], None
    for i in range(run.mix["check_steps"]):
        metrics = step(pool[i])
        losses.append({k: v for k, v in metrics.items()
                       if not k.startswith("metric_")})
        if i == 0:
            grad = {n: b.detach().float().cpu() - wd * p0[n]
                    for n, b in zip(optimizer.names, optimizer.bufs)}
    params = dict(model.named_parameters())
    delta = {n: params[n].detach().float().cpu() - p0[n] for n in grad}
    return {"losses": [{k: float(v) for k, v in m.items()} for m in losses],
            "grad": grad, "delta": delta}


def reference_steps(run, weights_cpu: dict, batches: list,
                    quant=None) -> dict:
    """The same steps by the float32 reference (``quant``: its lower
    precision control), from the same weights and batches."""
    model = Detector(run.config["family"], run.config["num_classes"],
                     run.config["box_version"]).to(run.device)
    model.load_state_dict(weights_cpu)
    model.set_quant(quant)
    out = {}

    def collect(i, grads, params):
        if i == 0:
            out["grad"] = _cpu(grads)

    losses, out["grad_norms"] = ref_det.train_steps(
        run.config, model, batches, chunk=run.mix["reference_chunk"],
        collect=collect)
    params = dict(model.named_parameters())
    out["delta"] = {n: params[n].detach().float().cpu() - weights_cpu[n]
                    for n in out["grad"]}
    out["losses"] = losses
    out["p0"] = {n: weights_cpu[n] for n in out["grad"]}
    return out


def k1_bound(run, batches) -> float:
    """The frozen roofline's least seconds for K1 over ``batches``: each
    batch's real ground truths against every anchor, less the pairs that
    the plain geometric test culls."""
    anchors = torch.cat(ref_det.level_anchors(run.config, run.device))
    total = 0.0
    for b in batches:
        real = b["gt_boxes"][b["gt_mask"]].float().contiguous()
        culled = int(pairwise_disjoint(real, anchors, block=64).sum())
        total += k1.bound_seconds(real.shape[0], anchors.shape[0],
                                  run.config["box_version"], culled)["seconds"]
    return total


def run_cell(run) -> dict:
    config, mix = run.config, run.mix
    parts = {"imports": time.perf_counter() - run.start}
    cfg = port.port_config(config)
    weights = make_weights(config, run.seed, run.device)
    weights_cpu = _cpu(weights)
    model, optimizer, step = port.build_train_step(cfg, weights, run.device,
                                                   run.seed)
    del weights
    pool = traffic.train_pool(config, mix, run.seed, run.device)
    run.synchronize()
    parts["build"] = time.perf_counter() - run.start - sum(parts.values())
    prog = checked_steps(run, model, optimizer, step, pool, weights_cpu)
    for batch in pool[mix["check_steps"]:]:
        step(batch)
    run.synchronize()
    setup_s = time.perf_counter() - run.start
    parts["steps"] = setup_s - sum(parts.values())

    n, losses = 0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        losses.append(step(pool[n % len(pool)])["loss"])
        n += 1
    run.synchronize()
    window = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    out = {"attempted": n, "failed": failed, "setup_parts": parts,
           "e2e": {"setup_s": setup_s,
                   "train_img_s": n * mix["batch"] / window}}

    if run.trace:
        calls = mix["trace_steps"]
        batches = [pool[(n + i) % len(pool)] for i in range(calls)]
        it = iter(batches)
        events = trace.profile_calls(lambda: step(next(it)), calls)
    out["memory_peak_bytes"] = run.memory_peak()
    if run.trace:
        summary = trace.summarize(events, calls)
        out["trace"] = summary
        out["layer"] = {
            "kind": "train", "steps": calls,
            "flops_per_step": model_flops(config, mix["batch"], True),
            "k1_bound_s": k1_bound(run, batches)
            if config.get("assign_backend") == K1_BACKEND else None,
            "k1_device_s": trace.kernel_seconds(summary, "pairwise_kernel"),
        }

    check = pool[:mix["check_steps"]]
    del model, optimizer, step, pool, losses
    run.free()
    with run.exact():
        ref = reference_steps(run, weights_cpu, check)
    out["numbers"] = judge.train_numbers(prog, ref)
    return out

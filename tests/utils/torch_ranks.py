"""One rank of a multi-process job of the port, started by
``tests/test_torch_parallel_ranks.py`` as ``python torch_ranks.py JOB
SPEC.json`` with torchrun's variables set. Imports the port and never JAX
(nor any test module). Writes what the test reads into the spec's
``out_dir``; prints one JSON line of its own at the end.

Jobs:

- ``steps``: for each model of the spec, one train step on this rank's half
  of a fixed batch; saves the gradients as summed over the ranks (before
  the optimiser's clip) and the parameters after the step.
- ``train``: ``train.main`` with ``--launcher torch``, then ``test.main``
  where the spec gives its arguments; counts this rank's file writes and
  digests its parameters and EMA shadow.
- ``sharded``: for each run of the spec, a mesh of its ``space``, the model
  partitioned over it and, with ``fsdp``, its state sharded; optionally a
  checkpoint loaded into the sharded state (and then no step), else one
  train step on this rank's part of the batch (``shard_batch_spatial``);
  rank 0 saves the whole gradients (summed over the ranks, before the
  optimiser's clip), the metrics summed over the data group, the whole
  state after the step, each parameter's local shape before and after and
  the neck outputs' global widths; every rank saves what its assignment
  saw (K1's input shapes, its anchors, its labels and positives) and the
  global width of each input of its head's calls. A run with ``overlaps``
  computes ``sharded_pairwise_overlaps`` and the unsharded ``sph_overlaps``
  instead; a run with ``predict``, the family's ``predict_fn`` on the whole
  batch's images (each rank cuts its own columns) and no step.
"""

import hashlib
import json
import os
import sys
import time

START = time.monotonic()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sph_retina_tpu_torch import parallel  # noqa: E402
from sph_retina_tpu_torch import test as test_cli  # noqa: E402
from sph_retina_tpu_torch import train as train_cli  # noqa: E402
from sph_retina_tpu_torch.engine import runner  # noqa: E402
from sph_retina_tpu_torch.engine.builder import build_tx  # noqa: E402
from sph_retina_tpu_torch.engine.zoo import (  # noqa: E402
    get_family,
    make_generic_train_step,
)
from sph_retina_tpu_torch.models import single_stage  # noqa: E402
from sph_retina_tpu_torch.utils.config import (  # noqa: E402
    apply_overrides,
    load_config,
)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def steps(spec: dict, rank: int, world: int) -> dict:
    """Also run in the test's own process at world 1, on the whole batch."""
    out = {}
    for name, model_spec in spec["models"].items():
        cfg = apply_overrides(load_config(model_spec["config"]),
                              model_spec["options"])
        family = get_family(cfg)
        model, det_cfg = family.build(cfg)
        model.load_state_dict(torch.load(model_spec["weights"]))
        optimizer = build_tx(cfg, model, steps_per_epoch=1,
                             num_processes=world)
        step = make_generic_train_step(family, model, det_cfg, optimizer)
        with np.load(model_spec["batch"]) as f:
            full = {k: f[k] for k in f.files}
        n = full["images"].shape[0] // world
        half = {k: torch.from_numpy(v[rank * n:(rank + 1) * n])
                for k, v in full.items() if k != "img_id"}
        synced = {}
        real_step = optimizer.step

        def stepping():
            synced.update({k: p.grad.clone() for k, p in
                           zip(optimizer.names, optimizer.params)})
            real_step()

        optimizer.step = stepping
        metrics = step(half)
        torch.save({"grads": synced, "params": model.state_dict(),
                    "metrics": {k: float(v) for k, v in metrics.items()}},
                   os.path.join(spec["out_dir"], f"{name}_rank{rank}.pt"))
        out[name] = digest(synced.values())
    return out


def _sharded_run(spec: dict, run: dict, rank: int, world: int) -> dict:
    from sph_retina_tpu_torch.iou.api import sph_overlaps

    parallel.set_data_axis()  # each run on its own mesh
    mesh = parallel.make_mesh(space=run["space"])
    if "overlaps" in run:
        with np.load(run["overlaps"]) as f:
            b1, b2 = torch.from_numpy(f["b1"]), torch.from_numpy(f["b2"])
        got = parallel.sharded_pairwise_overlaps(b1, b2, mesh)
        return {"got": got, "want": sph_overlaps(
            b1, b2, "sph2pob_efficient", is_aligned=False)}
    model_spec = spec["models"][run["model"]]
    cfg = apply_overrides(load_config(model_spec["config"]),
                          model_spec["options"])
    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    model.load_state_dict(torch.load(model_spec["weights"]))
    optimizer = build_tx(cfg, model, steps_per_epoch=1,
                         num_processes=world // run["space"])
    parallel.partition_spatially(model, mesh)
    if run.get("fsdp"):
        parallel.shard_state_fsdp(model, optimizer, mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if run.get("load"):
        runner.load_checkpoint(run["load"], model, optimizer)
        return {"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "shapes": shapes}
    with np.load(model_spec["batch"]) as f:
        full = {k: f[k] for k in f.files if k != "img_id"}
    if run.get("predict"):
        got = family.predict_fn(model, det_cfg)(
            torch.from_numpy(full["images"]))
        return {"detections": got._asdict()}
    step = make_generic_train_step(family, model, det_cfg, optimizer)
    synced = {}
    real_step = optimizer.step

    def stepping():
        synced.update(zip(optimizer.names, (g.clone() for g in
                                            parallel.sharding.full_tensors(
            [p.grad for p in optimizer.params], optimizer.params))))
        real_step()

    optimizer.step = stepping
    seen = {"k1_inputs": [], "assign": []}
    kernel, targets = single_stage.sph2pob_iou_pairwise, \
        single_stage.anchor_targets

    def kernel_seen(b1, b2):
        seen["k1_inputs"].append((tuple(b1.shape), tuple(b2.shape)))
        return kernel(b1, b2)

    def targets_seen(cfg, anchors, *args, **kwargs):
        t = targets(cfg, anchors, *args, **kwargs)
        seen["assign"].append({"anchors": anchors, "labels": t.labels,
                               "num_pos": int(t.num_pos)})
        return t

    single_stage.sph2pob_iou_pairwise = kernel_seen
    single_stage.anchor_targets = targets_seen
    try:
        metrics = parallel.global_metrics(step(parallel.shard_batch_spatial(
            full, mesh)))
    finally:
        single_stage.sph2pob_iou_pairwise = kernel
        single_stage.anchor_targets = targets
    axis = getattr(model, "space_axis", None)
    if axis is not None:
        seen["head_widths"] = [g for k, g in axis.plan.items()
                               if isinstance(k, tuple)
                               and isinstance(k[0], torch.nn.Module)
                               and k[0] is getattr(axis.head, "cls_conv_0",
                                                   None)]
    torch.save(seen, os.path.join(spec["out_dir"],
                                  f"{run['name']}_seen{rank}.pt"))
    out = dict(grads=synced,
               metrics={k: float(v) for k, v in metrics.items()},
               params=model.state_dict(),
               optimizer=optimizer.state_dict(), shapes_before=shapes,
               shapes_after={n: tuple(p.shape)
                             for n, p in model.named_parameters()},
               neck_widths=None if axis is None else [
                   g for k, g in axis.plan.items()
                   if isinstance(k, tuple) and k[0] == "out"])
    if run.get("save"):
        runner.RankZeroCheckpointer(run["save"]).save(model, optimizer, 1)
    return out


def sharded(spec: dict, rank: int, world: int) -> dict:
    seconds = {}
    for run in spec["runs"]:
        t0 = time.monotonic()
        out = _sharded_run(spec, run, rank, world)
        if rank == 0:
            torch.save(out, os.path.join(spec["out_dir"],
                                         f"{run['name']}.pt"))
        seconds[run["name"]] = time.monotonic() - t0
    return {"run_seconds": seconds}


def train(spec: dict, rank: int, world: int) -> dict:
    writes = []
    write = runner._write_atomically

    def counting(path, fn):
        writes.append(os.path.basename(path))
        return write(path, fn)

    runner._write_atomically = counting
    built = {}
    build = train_cli.build_training

    def capturing(*args, **kwargs):
        built["parts"] = build(*args, **kwargs)
        return built["parts"]

    train_cli.build_training = capturing
    assert train_cli.main(spec["train_argv"] + ["--launcher", "torch"]) == 0
    model, _, _, optimizer, _ = built["parts"]
    out = {"writes": writes, "params": digest(model.state_dict().values()),
           "ema": digest(optimizer.ema) if optimizer.ema else None}
    if spec.get("test_argv"):
        assert test_cli.main(spec["test_argv"] + ["--launcher", "torch"]) \
            == 0
    return out


def main() -> int:
    sys.modules["torch.utils.tensorboard"] = None  # it imports TensorFlow
    job, spec_path = sys.argv[1:]
    with open(spec_path) as f:
        spec = json.load(f)
    with parallel.process_group("torch", device="cpu",
                                timeout_s=spec["timeout_s"]) as (rank,
                                                                 world):
        out = {"steps": steps, "train": train,
               "sharded": sharded}[job](spec, rank, world)
        parallel.coordination_barrier("done", timeout_s=spec["timeout_s"])
    print(json.dumps({"rank": rank, "world": world,
                      "seconds": time.monotonic() - START, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

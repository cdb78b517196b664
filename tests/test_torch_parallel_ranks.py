"""The port's data parallelism across two processes, on the CPU: the only
port test file that starts processes.

Two gloo ranks a job (``tests/utils/torch_ranks.py``, which imports the port
and never JAX), torchrun's variables set by hand, R18 at 64x128 in fp32 as
the JAX package's own 2-process test runs (``tests/test_distributed.py``).
Four jobs start at once (three of two ranks, and the one-process reference
of the gradients at the ranks' one thread), a fourth 2-rank job once the
first has ended. Each rank logs to a file (a pipe nobody reads can block a
rank, and then its peer at the next collective). Every wait, for a job and
for each rendezvous and collective inside one, is at most ``WAIT_S``; a job
that is late is killed and fails the test. Everything the jobs wrote,
checkpoints included, is removed once the module is done.

Checked, with the tolerance of ``tests/test_torch_train_slice.py`` for one
step (gradients ``rtol=1e-3, atol=1e-5``, parameters ``atol=1e-5``):

- one 2-rank step of a RetinaNet (its two halves hold different numbers of
  positives) against the JAX package's one-process step on the whole
  4-image batch, from the same weights (``to_flax``); a local normaliser
  (each half's loss over its own positives, gradients summed) falls outside
  that tolerance, and its gap is larger than the tolerance ``chip_smoke.py``
  holds two ranks to on the card;
- the FCOS, SSD and Faster R-CNN gradients of one 2-rank step against the
  port's one-process gradients on the whole batch (Faster R-CNN with the
  OHEM sampler, which draws nothing at random);
- one epoch, then ``--auto-resume`` to two, equals two epochs bit for bit,
  the EMA shadow included, on both ranks alike; only rank 0 writes
  checkpoints and ``metrics.jsonl``; each rank says ``process r/2``; the
  gathered evaluation counts the dataset's 8 images;
- ``test.main --launcher torch`` at 2 ranks gives the one-process metrics.
"""

import ast
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sph_retina_tpu.engine.builder import build_tx as jax_build_tx
from sph_retina_tpu.engine.zoo import get_family as jax_get_family
from sph_retina_tpu.models import single_stage as jss
from sph_retina_tpu.utils.config import load_config as jax_load_config
from sph_retina_tpu_torch import test as test_cli
from sph_retina_tpu_torch.data import (
    DataLoader,
    SphPipeline,
    make_synthetic_dataset,
)
from sph_retina_tpu_torch.engine.builder import build_tx
from sph_retina_tpu_torch.engine.runner import read_checkpoint
from sph_retina_tpu_torch.engine.zoo import get_family
from sph_retina_tpu_torch.models import single_stage as tss
from sph_retina_tpu_torch.models.from_flax import to_flax
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config

from test_torch_assign_loss import port_iou_callback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "utils", "torch_ranks.py")
WAIT_S = 60.0
H, W = 64, 128
SMALL = ["img_size=(64,128)", "bf16=False", "model.backbone.depth=18",
         "data.max_gt=8"]

RETINA_CFG = """\
model = dict(type="SphRetinaNet", num_classes=7, box_version=5,
             backbone=dict(depth=18, frozen_stages=1))
img_size = (64, 128)
bf16 = False
optimizer = dict(lr=0.01, momentum=0.9, weight_decay=5e-4)
optimizer_config = dict(grad_clip=dict(max_norm=35.0))
lr_config = dict(step=[80, 110], warmup_iters=4, warmup_ratio=0.1)
ema_momentum = 0.01
"""

# tests/test_distributed.py's TINY_CFG, with an EMA shadow
TINY_CFG = """\
model = dict(type="SphRetinaNet", num_classes=3, backbone=dict(depth=18))
img_size = (64, 128)
bf16 = False
data = dict(samples_per_gpu=2, max_gt=8, n_synthetic=8)
runner = dict(max_epochs=1)
evaluation = dict(interval=1)
checkpoint_config = dict(interval=1)
optimizer = dict(lr=0.001)
optimizer_config = dict(grad_clip=dict(max_norm=35.0))
log_config = dict(interval=1)
ema_momentum = 0.01
"""

FAMILY_CONFIGS = {
    "fcos": "sph_fcos_r50_fpn_120e_indoor360.py",
    "ssd": "sph_ssd_vgg16_120e_indoor360.py",
    "frcnn": "sph_faster_rcnn_r50_fpn_ohem_120e_indoor360.py",
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Job:
    """``world`` ranks of ``torch_ranks.py JOB SPEC``, each logging to a
    file."""

    def __init__(self, name: str, job: str, spec: dict, root,
                 world: int = 2):
        self.name, self.root = name, root
        spec = dict(spec, timeout_s=WAIT_S, out_dir=str(root))
        spec_path = root / f"{name}.json"
        spec_path.write_text(json.dumps(spec))
        port = _free_port()
        self.procs, self.logs = [], []
        for rank in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank),
                       OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join(
                           [REPO, os.environ.get("PYTHONPATH", "")]))
            log = root / f"{name}_rank{rank}.log"
            self.logs.append(log)
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, CHILD, job, str(spec_path)], env=env,
                    cwd=REPO, stdout=f, stderr=subprocess.STDOUT))

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)

    def said(self, rank: int) -> str:
        return self.logs[rank].read_text()

    def finish(self) -> list:
        """Each rank's closing JSON line; a rank that fails, or is not done
        ``WAIT_S`` after this call, fails the test, and all are killed."""
        deadline = time.monotonic() + WAIT_S
        try:
            for p in self.procs:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(
                f"job {self.name} ran past {WAIT_S} s:\n"
                + "\n".join(self.said(r)[-2000:]
                            for r in range(len(self.procs))))
        if any(p.returncode != 0 for p in self.procs):
            self.kill()
            raise AssertionError(
                f"job {self.name} failed ({[p.returncode for p in self.procs]}"
                "):\n" + "\n".join(self.said(r)[-3000:]
                                   for r in range(len(self.procs))))
        return [json.loads(self.said(r).strip().splitlines()[-1])
                for r in range(len(self.procs))]


def _batch(box_version: int, classes: int, seed: int) -> dict:
    ds = make_synthetic_dataset(n_images=4, num_classes=classes,
                                img_size=(H, W), box_version=box_version,
                                seed=seed)
    pipe = SphPipeline(img_size=(H, W), max_gt=8, box_version=box_version)
    return next(DataLoader(ds, pipe, batch_size=4, shuffle=False).epoch(0))


def _save_model(cfg: dict, path) -> None:
    model = get_family(cfg).build(cfg)[0]
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), path)


def _jax_step(cfg_path, weights, batch):
    """The JAX package's one-process step on the whole batch: its gradients
    and its parameters after the update (its optax chain), from the port's
    weights carried across with ``to_flax``; both packages' assigners see
    the port's overlaps (``port_iou_callback``)."""
    jcfg = jax_load_config(str(cfg_path))
    jfam = jax_get_family(jcfg)
    jmodel, jdet = jfam.build(jcfg)
    params, stats = to_flax(torch.load(weights))
    loss = jfam.loss_fn(jmodel, jdet)
    tcfg = get_family(load_config(str(cfg_path))).build(
        load_config(str(cfg_path)))[1]
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("images", "gt_boxes", "gt_labels", "gt_mask")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jss, "_batch_pairwise_iou",
                   port_iou_callback(tcfg.flat_anchors()))
        (_, _), grads = jax.jit(jax.value_and_grad(
            lambda p: loss({"params": p, "batch_stats": stats}, jbatch,
                           None), has_aux=True))(params)
    tx = jax_build_tx(jcfg, steps_per_epoch=1)
    updates, _ = tx.update(grads, tx.init(params), params)
    return (jax.device_get(grads),
            jax.device_get(optax.apply_updates(params, updates)), params)


def _local_normaliser_step(cfg_path, weights, batch):
    """The 2-rank step with each half's loss over its own positives: the
    halves' gradients summed, then the port's optimiser. Returns the
    gradients and the parameters after."""
    cfg = load_config(str(cfg_path))
    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    model.load_state_dict(torch.load(weights))
    optimizer = build_tx(cfg, model, steps_per_epoch=1)
    loss = family.loss_fn(model, det_cfg)
    for half in (slice(0, 2), slice(2, 4)):
        total, _ = loss({k: torch.from_numpy(v[half])
                         for k, v in batch.items() if k != "img_id"})
        total.backward()
    grads = {n: p.grad.clone() for n, p in
             zip(optimizer.names, optimizer.params)}
    optimizer.step()
    return grads, model.state_dict()


def _positives(cfg_path, batch) -> list:
    cfg = load_config(str(cfg_path))
    det_cfg = get_family(cfg).build(cfg)[1]
    return [int(tss.anchor_targets(
        det_cfg, det_cfg.flat_anchors(),
        *(torch.from_numpy(batch[k][half])
          for k in ("gt_boxes", "gt_labels", "gt_mask"))).num_pos)
        for half in (slice(0, 2), slice(2, 4))]


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _close(got: dict, want, **tol) -> None:
    """Every leaf of the port's ``got`` (a state dict) against the same
    leaf of the JAX tree ``want``."""
    want = dict(_leaves(want))
    got = dict(_leaves(to_flax(got)[0]))
    assert got and set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **tol)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    jobs = []
    try:
        retina_cfg = root / "retina.py"
        retina_cfg.write_text(RETINA_CFG)
        tiny_cfg = root / "tiny.py"
        tiny_cfg.write_text(TINY_CFG)
        models = {}
        retina_batch = _batch(5, 7, seed=2)
        np.savez(root / "batch5.npz", **retina_batch)
        _save_model(load_config(str(retina_cfg)), root / "retina.pt")
        models["retina"] = {"config": str(retina_cfg), "options": [],
                            "weights": str(root / "retina.pt"),
                            "batch": str(root / "batch5.npz")}
        np.savez(root / "batch4.npz", **_batch(4, 3, seed=3))
        for name, config in FAMILY_CONFIGS.items():
            path = os.path.join(REPO, "configs", config)
            _save_model(apply_overrides(load_config(path), SMALL),
                        root / f"{name}.pt")
            models[name] = {"config": path, "options": SMALL,
                            "weights": str(root / f"{name}.pt"),
                            "batch": str(root / "batch4.npz")}
        cli = ["--synthetic", "--device", "cpu"]
        steps = Job("steps", "steps", {"models": models}, root)
        # the one-process reference, at the ranks' one thread: FCOS's
        # gradients move 6.5e-5 between 1 and 8 threads on the same batch,
        # beyond the tolerance (ROADMAP C14)
        world_one = root / "world_one"
        world_one.mkdir()
        one = Job("one", "steps", {"models": models}, world_one, world=1)
        first = Job("first_epoch", "train", {"train_argv": [
            str(tiny_cfg), *cli, "--work-dir", str(root / "resumed"),
            "--max-epochs", "1"]}, root)
        whole = Job("two_epochs", "train", {
            "train_argv": [str(tiny_cfg), *cli, "--work-dir",
                           str(root / "whole"), "--max-epochs", "2"],
            "test_argv": [str(tiny_cfg), str(root / "whole" / "ckpts"), *cli,
                          "--out", str(root / "test_2ranks.json")]}, root)
        jobs += [steps, one, first, whole]

        # meanwhile, in this process: the references
        jgrads, jparams, jparams0 = _jax_step(retina_cfg, models["retina"][
            "weights"], retina_batch)
        out = {"first": first.finish()}
        resume = Job("resume", "train", {"train_argv": [
            str(tiny_cfg), *cli, "--work-dir", str(root / "resumed"),
            "--max-epochs", "2", "--auto-resume"]}, root)
        jobs.append(resume)
        local = _local_normaliser_step(retina_cfg, models["retina"][
            "weights"], retina_batch)
        out.update(steps=steps.finish(), one=one.finish(),
                   whole=whole.finish(), resume=resume.finish())
        test_cli.main([str(tiny_cfg), str(root / "whole" / "ckpts"), *cli,
                       "--out", str(root / "test_1rank.json")])
        print({k: [r["seconds"] for r in v] for k, v in out.items()})
        yield dict(
            out, root=root, jobs={j.name: j for j in jobs},
            jgrads=jgrads, jparams=jparams, jparams0=jparams0, local=local,
            positives=_positives(retina_cfg, retina_batch),
            two={name: [torch.load(root / f"{name}_rank{r}.pt")
                        for r in range(2)] for name in models},
            one={name: torch.load(world_one / f"{name}_rank0.pt")
                 for name in models})
    finally:
        for job in jobs:
            job.kill()
        shutil.rmtree(root, ignore_errors=True)


def _smoke_tolerance() -> float:
    """``chip_smoke.PARALLEL_TOLERANCE``, read from the file (importing the
    smoke would import every module it drives)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    (value,) = [node.value.value for node in tree.body
                if isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["PARALLEL_TOLERANCE"]]
    return value


def test_two_rank_step_equals_the_jax_single_process_step(ranks):
    # where the halves' positives were equal, a local normaliser would be
    # the global one and the test could not tell them apart
    assert ranks["positives"][0] != ranks["positives"][1]
    rank0, rank1 = ranks["two"]["retina"]
    for k in rank0["grads"]:
        assert torch.equal(rank0["grads"][k], rank1["grads"][k]), k
    for k in rank0["params"]:
        assert torch.equal(rank0["params"][k], rank1["params"][k]), k
    _close(rank0["grads"], ranks["jgrads"], rtol=1e-3, atol=1e-5)
    _close(rank0["params"], ranks["jparams"], atol=1e-5, rtol=0)


def _update_gap(params: dict, want: dict, start) -> float:
    """max|dθ - dθ_want| / max|dθ_want| over the parameters."""
    start = dict(_leaves(start))
    got = dict(_leaves(to_flax(params)[0]))
    want = dict(_leaves(to_flax(want)[0]))
    num = max(float(np.abs((got[k] - start[k]) - (want[k] - start[k])).max())
              for k in want)
    den = max(float(np.abs(want[k] - start[k]).max()) for k in want)
    return num / den


def test_a_local_normaliser_falls_outside_the_tolerance(ranks):
    grads, params = ranks["local"]
    with pytest.raises(AssertionError):
        _close(grads, ranks["jgrads"], rtol=1e-3, atol=1e-5)
    with pytest.raises(AssertionError):
        _close(params, ranks["jparams"], atol=1e-5, rtol=0)
    two = ranks["two"]["retina"][0]["params"]
    gap = _update_gap(params, two, ranks["jparams0"])
    exact = _update_gap(two, two, ranks["jparams0"])
    print(f"local normaliser: update gap {gap:.6g} against the 2-rank step")
    assert exact == 0.0
    assert gap > _smoke_tolerance()


@pytest.mark.parametrize("name", sorted(FAMILY_CONFIGS))
def test_family_gradients_equal_one_process(ranks, name):
    rank0, rank1 = ranks["two"][name]
    want = ranks["one"][name]["grads"]
    assert rank0["grads"].keys() == want.keys()
    for k, g in want.items():
        assert torch.equal(rank0["grads"][k], rank1["grads"][k]), k
        np.testing.assert_allclose(rank0["grads"][k].numpy(), g.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    assert any(float(g.abs().max()) > 1e-3 for g in want.values())


def test_resume_equals_an_uninterrupted_run(ranks):
    resumed = read_checkpoint(str(ranks["root"] / "resumed" / "ckpts" /
                                  "epoch_2"))
    whole = read_checkpoint(str(ranks["root"] / "whole" / "ckpts" /
                                "epoch_2"))
    assert resumed["step"] == whole["step"] == 4
    for k, v in whole["model"].items():
        assert torch.equal(resumed["model"][k], v), k
    for part in ("momentum_buffers", "ema"):
        assert whole["optimizer"][part].keys() == \
            resumed["optimizer"][part].keys()
        for k, v in whole["optimizer"][part].items():
            assert torch.equal(resumed["optimizer"][part][k], v), (part, k)
    assert len(whole["generators"]) == 2
    # every rank ends alike, its EMA shadow too (it follows the synced
    # parameters)
    digests = {(r["params"], r["ema"]) for job in ("resume", "whole")
               for r in ranks[job]}
    assert len(digests) == 1 and None not in next(iter(digests))
    assert "resumed from step 2" in ranks["jobs"]["resume"].said(1)


def test_only_rank_zero_writes(ranks):
    for job in ("first", "whole", "resume"):
        rank0, rank1 = ranks[job]
        assert rank1["writes"] == []
        assert "latest.txt" in rank0["writes"]
    records = [json.loads(line) for line in
               (ranks["root"] / "whole" / "metrics.jsonl").read_text()
               .splitlines()]
    assert [r["step"] for r in records if r["prefix"] == "train"] == \
        [1, 2, 3, 4]
    val = [r for r in records if r["prefix"] == "val"]
    assert [r["n_images"] for r in val] == [8, 8]
    for rank in range(2):
        said = ranks["jobs"]["two_epochs"].said(rank)
        assert f"process {rank}/2; backend: gloo; device: cpu" in said
        assert ("\nplatform: " in said) == (rank == 0)  # the environment


def test_test_cli_at_two_ranks_gives_one_process_metrics(ranks):
    two = json.loads((ranks["root"] / "test_2ranks.json").read_text())
    one = json.loads((ranks["root"] / "test_1rank.json").read_text())
    assert two.keys() == one.keys() and "mAP" in two
    for k in one:
        assert two[k] == pytest.approx(one[k], abs=1e-6), k
    said = ranks["jobs"]["two_epochs"].said(1)
    assert "mAP" not in said  # only rank 0 prints the metrics


SCRIPTS = os.path.join(REPO, "sph_retina_tpu_torch", "scripts")


@pytest.mark.parametrize("name", ["dist_test.sh", "dist_train.sh",
                                  "dist_train_det.sh", "slurm_test.sh",
                                  "slurm_train.sh"])
def test_launcher_script_parses(name):
    path = os.path.join(SCRIPTS, name)
    assert os.access(path, os.X_OK)
    subprocess.run(["bash", "-n", path], check=True, timeout=WAIT_S)


def test_dist_train_script_takes_a_step_on_the_cpu(tmp_path):
    """``scripts/dist_train.sh CONFIG 1 --synthetic --device cpu``: torchrun
    starts one gloo rank of ``train.py --launcher torch``, which takes one
    step at 64x128 and writes its checkpoint, within ``WAIT_S``. The child
    finds ``torch.utils.tensorboard`` unimportable (a ``sitecustomize`` on
    its path): it imports TensorFlow where that is installed."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY_CFG)
    work = tmp_path / "work"
    env = dict(os.environ, PORT=str(_free_port()), PYTHON=sys.executable,
               PYTHONPATH=os.pathsep.join(
                   [str(site)] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else [])))
    proc = subprocess.Popen(
        [os.path.join(SCRIPTS, "dist_train.sh"), str(cfg), "1",
         "--synthetic", "--device", "cpu", "--work-dir", str(work),
         "--cfg-options", "data.n_synthetic=2", "evaluation=None"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        said, _ = proc.communicate(timeout=WAIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        said, _ = proc.communicate()
        pytest.fail(f"dist_train.sh ran past {WAIT_S} s:\n{said[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
    try:
        assert proc.returncode == 0, said[-3000:]
        assert "process 0/1; backend: gloo; device: cpu" in said
        records = [json.loads(line) for line in
                   (work / "metrics.jsonl").read_text().splitlines()]
        steps = [r for r in records if r["prefix"] == "train"]
        assert [r["step"] for r in steps] == [1]
        assert np.isfinite(steps[0]["loss"])
        assert (work / "ckpts" / "latest.txt").read_text().strip() \
            == "epoch_1"
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)

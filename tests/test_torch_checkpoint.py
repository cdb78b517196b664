"""Checkpoints, resume, the EMA swap, publishing and the training workflow of
the port, on the CPU.

- ``Checkpointer``: ``latest.txt`` advances only after the checkpoint file is
  complete; a dangling or missing pointer falls back to the newest complete
  ``epoch_N``; no checkpoint gives None; ``best`` follows the metric; a
  temporary file is never taken for a checkpoint;
- resume equals an uninterrupted run, parameters, momentum buffers and the
  generator bitwise, on RetinaNet and on the Faster R-CNN R18 leaf, whose
  random RoI sampler draws from the train step's generator (ROADMAP C10: a
  resume that leaves the generator where a fresh one starts draws other
  RoIs, which the test shows too);
- ``with_ema_params`` against the JAX package's, leaf by leaf through
  ``to_flax``, 1e-6;
- ``save_published`` writes the JAX layout: the JAX package's
  ``load_published`` reads it leaf for leaf, and its ``init_detector`` on it
  predicts what the port's ``init_detector`` predicts on the checkpoint
  directory (scores 1e-4, boxes 5e-3 degrees as in the serving slice's test);
- ``memory_report``'s keys;
- the workflow of ``tests/test_integration_run.py`` through the port's
  CLIs, called in-process: train 2 epochs with evaluation and checkpoints,
  ``--auto-resume`` to 4 with no step replayed, ``test.main`` reproducing the
  last in-training AP50 within 1e-4, and a class-count mismatch failing
  before any step.
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from sph_retina_tpu import apis as japis
from sph_retina_tpu.engine import train as jtrain
from sph_retina_tpu.utils.publish import load_published as jax_load_published
from sph_retina_tpu_torch import apis as tapis
from sph_retina_tpu_torch import publish as publish_cli
from sph_retina_tpu_torch import test as test_cli
from sph_retina_tpu_torch import train as train_cli
from sph_retina_tpu_torch.engine.runner import (
    Checkpointer,
    MetricLogger,
    memory_report,
    read_checkpoint,
    run_training,
)
from sph_retina_tpu_torch.engine.train import get_ema_params, with_ema_params
from sph_retina_tpu_torch.models.from_flax import to_flax
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config
from sph_retina_tpu_torch.utils.publish import save_published

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from utils.synthetic_coco import write_synthetic_coco  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL = ["model.backbone.depth=18", "img_size=(64,128)", "bf16=False",
         "data.samples_per_gpu=2", "data.n_synthetic=4", "data.max_gt=8",
         "log_config.interval=1", "lr_config.warmup_iters=2"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _tiny(seed=0):
    """A model and an optimiser small enough to save in milliseconds."""
    from sph_retina_tpu_torch.engine.train import (
        build_optimizer,
        step_lr_schedule,
    )

    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                torch.nn.BatchNorm1d(4))
    opt = build_optimizer(model, step_lr_schedule(0.1, 1), ema_momentum=0.5)
    return model, opt


def test_checkpointer_commit_order_fallback_and_best(tmp_path, monkeypatch):
    model, opt = _tiny()
    ck = Checkpointer(str(tmp_path / "ckpts"))
    assert ck.latest_path() is None
    assert ck.restore(model, opt) == 0  # nothing to restore

    # the pointer is written only after the checkpoint file is complete
    order = []
    real_replace = os.replace

    def recording(src, dst):
        order.append((os.path.basename(src), os.path.basename(dst),
                      os.path.isfile(os.path.join(ck.dir, "epoch_1"))))
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", recording)
    opt.count = 3
    ck.save(model, opt, 1, metric=0.2)
    monkeypatch.setattr(os, "replace", real_replace)
    assert order == [("epoch_1.tmp", "epoch_1", False),
                     ("latest.txt.tmp", "latest.txt", True),
                     ("best.tmp", "best", True)]
    assert ck.latest_path().endswith("epoch_1")
    assert ck.best == 0.2

    opt.count = 7
    with torch.no_grad():
        model[0].weight.add_(1.0)
    saved = model[0].weight.clone()
    ck.save(model, opt, 2, metric=0.1)  # no improvement: best stays epoch 1
    assert ck.latest_path().endswith("epoch_2")
    assert read_checkpoint(os.path.join(ck.dir, "best"))["step"] == 3
    ck.save(model, opt, 3, metric=0.5)
    assert read_checkpoint(os.path.join(ck.dir, "best"))["step"] == 7
    assert ck.best == 0.5
    os.remove(os.path.join(ck.dir, "epoch_3"))

    # dangling pointer -> the newest complete epoch_N on disk; a temporary
    # file of a later save that never finished is not one
    (tmp_path / "ckpts" / "epoch_9.tmp").write_bytes(b"partial")
    assert ck.latest_path().endswith("epoch_2")
    os.remove(os.path.join(ck.dir, "latest.txt"))
    assert ck.latest_path().endswith("epoch_2")
    fresh, fresh_opt = _tiny(seed=1)
    assert ck.restore(fresh, fresh_opt) == 7
    assert fresh_opt.count == 7
    assert torch.equal(fresh[0].weight, saved)
    for a, b in zip(fresh_opt.ema, opt.ema):
        assert torch.equal(a, b)
    assert torch.equal(fresh[1].running_var, model[1].running_var)

    # another package's file, or a file that is not there, is refused
    torch.save({"model": {}}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="not a checkpoint"):
        ck.restore(fresh, fresh_opt, path=str(tmp_path / "other.pt"))
    with pytest.raises(FileNotFoundError, match="nowhere"):
        ck.restore(fresh, fresh_opt, path=str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="no checkpoint in"):
        Checkpointer(str(tmp_path / "empty")).restore(
            fresh, fresh_opt, path=str(tmp_path / "empty"))
    assert Checkpointer(str(tmp_path / "empty")).latest_path() is None


def _resume_run(cfg, work, epochs, resume_from=None, generator=True):
    """``run_training`` for ``epochs`` epochs with a checkpoint after each
    into ``work``, optionally restored first from the checkpoint file
    ``resume_from`` (with the generator's state, or leaving the generator
    where a fresh one starts); returns (model, optimiser, train step)."""
    model, _, loader, optimizer, step = train_cli.build_training(cfg, CPU, 0)
    ck = Checkpointer(str(work))
    if resume_from:
        ck.restore(model, optimizer, path=str(resume_from),
                   generator=step.generator if generator else None)
    logger = MetricLogger(str(work), interval=100)
    try:
        run_training(train_step=step, optimizer=optimizer, loader=loader,
                     max_epochs=epochs, logger=logger, checkpointer=ck,
                     ckpt_interval=1, model=model,
                     transfer=lambda b: {k: torch.from_numpy(v)
                                         for k, v in b.items()
                                         if k != "img_id"})
    finally:
        logger.close()
    return model, optimizer, step


def _equal_parts(a, b) -> dict:
    """Which of the parameters, the momentum buffers and the generator's
    state of two runs are bitwise equal."""
    (ma, oa, sa), (mb, ob, sb) = a, b
    assert oa.count == ob.count
    sda, sdb = ma.state_dict(), mb.state_dict()
    assert sda.keys() == sdb.keys()
    return {
        "model": all(torch.equal(sda[k], sdb[k]) for k in sda),
        "momentum": all(torch.equal(x, y) for x, y in zip(oa.bufs, ob.bufs)),
        "generator": torch.equal(sa.generator.get_state(),
                                 sb.generator.get_state())}


@pytest.fixture
def emptied_tmp_path(tmp_path):
    """``tmp_path``, emptied once the test is done with it: the runs write
    checkpoints of ~160-230 MB each there."""
    yield tmp_path
    for path in tmp_path.iterdir():
        if path.is_dir():
            shutil.rmtree(path, ignore_errors=True)
        else:
            path.unlink()


@pytest.mark.usefixtures("emptied_tmp_path")
@pytest.mark.parametrize("config", [
    "sph_rotated_retinanet_r50_fpn_120e_pandora.py",
    "sph_faster_rcnn_r18_fpn_24e_spherebench.py",
])
def test_resume_equals_an_uninterrupted_run(config, tmp_path):
    cfg = apply_overrides(load_config(os.path.join(REPO, "configs", config)),
                          SMALL)
    straight = _resume_run(cfg, tmp_path / "straight", 2)
    _resume_run(cfg, tmp_path / "split", 1)
    after_epoch_1 = tmp_path / "split" / "epoch_1"
    resumed = _resume_run(cfg, tmp_path / "resumed", 2,
                          resume_from=after_epoch_1)
    assert straight[1].count == 4
    assert _equal_parts(straight, resumed) == {
        "model": True, "momentum": True, "generator": True}
    if "faster_rcnn" in config:
        # the fault this guards (C10): with the generator where a fresh one
        # starts, the resumed run samples other RoIs and ends elsewhere
        forgetful = _resume_run(cfg, tmp_path / "forgetful", 2,
                                resume_from=after_epoch_1, generator=False)
        assert _equal_parts(straight, forgetful) == {
            "model": False, "momentum": False, "generator": False}


def test_with_ema_params_equals_the_jax_packages():
    cfg = apply_overrides(load_config(os.path.join(
        REPO, "configs", "sph_rotated_retinanet_r50_fpn_120e_pandora.py")),
        SMALL + ["ema_momentum=0.01"])
    model, _, _, optimizer, _ = train_cli.build_training(cfg, CPU, 0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for e in optimizer.ema:
            e.copy_(torch.from_numpy(
                rng.normal(size=tuple(e.shape)).astype(np.float32)))
    params, stats = to_flax(model.state_dict())
    ema, _ = to_flax({k: v for k, v in get_ema_params(optimizer).items()})
    state = jtrain.TrainState(np.int32(0), params, stats,
                              (jtrain.EmaState(ema),))
    want = jax.device_get(jtrain.with_ema_params(state).params)
    assert with_ema_params(model, optimizer) is model
    got, got_stats = to_flax(model.state_dict())
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, flat_want[path], atol=1e-6, rtol=0)
    for (p1, a), (p2, b) in zip(jax.tree_util.tree_leaves_with_path(stats),
                                jax.tree_util.tree_leaves_with_path(
                                    got_stats)):
        assert p1 == p2
        np.testing.assert_array_equal(a, b)  # batch norm left alone

    plain, _, _, no_ema, _ = train_cli.build_training(
        apply_overrides(cfg, ["ema_momentum=None"]), CPU, 0)
    assert get_ema_params(no_ema) is None
    before = {k: v.clone() for k, v in plain.state_dict().items()}
    assert with_ema_params(plain, no_ema) is plain
    assert all(torch.equal(before[k], v)
               for k, v in plain.state_dict().items())


def test_memory_report_keys():
    stats = memory_report()
    assert {"host_available_mb", "host_total_mb", "process_rss_mb"} <= set(
        stats)
    assert all(isinstance(v, int) and v >= 0 for v in stats.values())
    device_keys = {k for k in stats if k.startswith("device")}
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert device_keys == {f"device{i}_{s}_mb" for i in range(n)
                           for s in ("in_use", "peak")}


CFG_TMPL = """\
model = dict(type="SphRetinaNet", num_classes={classes}, backbone=dict(depth=18))
img_size = (64, 128)
bf16 = False
data = dict(
    samples_per_gpu=4,
    workers_per_gpu=2,
    max_gt=8,
    flip_ratio=0.5,
    train=dict(ann_file={ann!r}, img_prefix={img!r}),
    val=dict(ann_file={ann!r}, img_prefix={img!r}),
    test=dict(ann_file={ann!r}, img_prefix={img!r}),
)
optimizer = dict(lr=0.01)
optimizer_config = dict(grad_clip=dict(max_norm=35.0))
lr_config = dict(step=(100,), warmup_iters=4)
runner = dict(max_epochs=4)
evaluation = dict(interval=2)
checkpoint_config = dict(interval=2)
log_config = dict(interval=1)
frozen_prefixes = ()
"""


def _records(work):
    return [json.loads(line) for line in
            (work / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """The config of ``tests/test_integration_run.py`` on a 16-image COCO
    set, trained for 2 epochs, then resumed to 4; returns (config path,
    work dir, records after the first run, the resumed run's output)."""
    tmp = tmp_path_factory.mktemp("workflow")
    ann, img_dir = write_synthetic_coco(str(tmp / "data"), n_images=16,
                                        num_classes=3, img_size=(64, 128))
    cfg = tmp / "cfg.py"
    cfg.write_text(CFG_TMPL.format(classes=3, ann=ann, img=img_dir + "/"))
    work = tmp / "work"
    sys.modules["torch.utils.tensorboard"] = None
    try:
        argv = [str(cfg), "--device", "cpu", "--work-dir", str(work),
                "--seed", "3"]
        assert train_cli.main(argv + ["--max-epochs", "2"]) == 0
        first = _records(work)
        said = _capture(lambda: train_cli.main(
            argv + ["--max-epochs", "4", "--auto-resume"]))
    finally:
        del sys.modules["torch.utils.tensorboard"]
    yield cfg, work, first, said
    shutil.rmtree(tmp, ignore_errors=True)  # its checkpoints


def _capture(fn):
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn() == 0
    return out.getvalue()


def test_workflow_trains_evaluates_checkpoints_and_resumes(workflow):
    cfg, work, first, said = workflow
    steps1 = [r["step"] for r in first if r["prefix"] == "train"]
    assert steps1 == list(range(1, 9))  # 16 images / batch 4 x 2 epochs
    assert [r["step"] for r in first if r["prefix"] == "val"] == [8]
    assert sorted(os.listdir(work / "ckpts")) == [
        "best", "epoch_2", "epoch_4", "latest.txt"]
    assert (work / "ckpts" / "latest.txt").read_text() == "epoch_4"

    assert "resumed from step 8" in said
    records = _records(work)
    steps2 = [r["step"] for r in records[len(first):] if r["prefix"] == "train"]
    assert steps2 == list(range(9, 17))  # no step replayed
    vals = [r for r in records if r["prefix"] == "val"]
    assert [r["step"] for r in vals] == [8, 16]
    assert all(np.isfinite(r[k]) for r in vals for k in ("mAP", "AP50",
                                                         "AP75"))
    assert all(r["n_images"] == 16 for r in vals)
    assert read_checkpoint(str(work / "ckpts" / "epoch_4"))["step"] == 16
    losses = [(r["step"], r["loss"]) for r in records
              if r["prefix"] == "train"]
    early = np.mean([v for s, v in losses if s <= 2])
    late = np.mean([v for s, v in losses if s >= 14])
    assert late < early, (early, late)


def test_test_cli_reproduces_the_last_evaluation(workflow, tmp_path):
    cfg, work, _, _ = workflow
    out = tmp_path / "res.json"
    said = _capture(lambda: test_cli.main([
        str(cfg), str(work / "ckpts"), "--device", "cpu", "--out", str(out)]))
    assert "loaded checkpoint at step 16" in said
    res = json.loads(out.read_text())
    assert set(res) == {"mAP", "AP50", "AP75"}
    last = [r for r in _records(work) if r["prefix"] == "val"][-1]
    np.testing.assert_allclose(res["AP50"], last["AP50"], atol=1e-4)
    # one epoch_N file, and the EMA that this run did not keep
    said = _capture(lambda: test_cli.main([
        str(cfg), str(work / "ckpts" / "epoch_2"), "--device", "cpu"]))
    assert "loaded checkpoint at step 8" in said
    with pytest.raises(SystemExit, match="no EMA state"):
        test_cli.main([str(cfg), str(work / "ckpts"), "--device", "cpu",
                       "--ema"])


def test_publish_is_read_by_the_jax_package(workflow, tmp_path):
    cfg, work, _, _ = workflow
    said = _capture(lambda: publish_cli.main([
        str(cfg), str(work / "ckpts"), str(tmp_path / "pub" / "model"),
        "--device", "cpu"]))
    (path,) = [str(p) for p in (tmp_path / "pub").iterdir()]
    assert f"published -> {path}" in said
    name = os.path.basename(path)
    assert name.startswith("model-") and name.endswith(".npz")
    assert len(name) == len("model-") + 8 + len(".npz")

    model, _, step = test_cli.load_for_eval(load_config(str(cfg)),
                                            str(work / "ckpts"), CPU)
    params, stats, meta = jax_load_published(path)
    assert meta == {"step": 16, "config": "cfg.py", "ema": False} \
        and step == 16
    want_params, want_stats = to_flax(model.state_dict())
    for got_tree, want_tree in ((params, want_params), (stats, want_stats)):
        got = jax.tree_util.tree_leaves_with_path(got_tree)
        want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
        assert len(got) == len(want)
        for p, leaf in got:
            np.testing.assert_array_equal(leaf, want[p])

    # both init_detectors; a low score threshold so that a short training's
    # scores pass it
    opts = ["test_cfg.score_thr=0.01"]
    jdet = japis.init_detector(str(cfg), checkpoint=path, cfg_options=opts)
    tdet = tapis.init_detector(str(cfg), str(work / "ckpts"),
                               cfg_options=opts, device="cpu")
    image = np.random.default_rng(0).integers(0, 256, (64, 128, 3),
                                              dtype=np.uint8)
    want = japis.inference_detector(jdet, image)
    got = tapis.inference_detector(tdet, image)
    assert sum(len(c) for c in got) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g[:, -1], w[:, -1], atol=1e-4, rtol=0)
        np.testing.assert_allclose(g[:, :-1], w[:, :-1], atol=5e-3, rtol=0)


def test_save_published_normalises_the_path(tmp_path):
    params = {"a": {"kernel": np.ones((2, 2), np.float32)}}
    got = save_published(str(tmp_path / "m"), params, None, {"k": 1})
    assert os.path.dirname(got) == str(tmp_path)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(got)]
    again = save_published(str(tmp_path / "n.npz"), params, None, {"k": 1})
    # the same content, the same hash
    assert got[-12:] == again[-12:]
    p, s, m = jax_load_published(again)
    np.testing.assert_array_equal(p["a"]["kernel"], params["a"]["kernel"])
    assert s == {} and m == {"k": 1}


def test_num_class_mismatch_fails_before_a_step(tmp_path):
    ann, img_dir = write_synthetic_coco(str(tmp_path / "data"), n_images=4,
                                        num_classes=3, img_size=(64, 128))
    cfg = tmp_path / "cfg.py"
    cfg.write_text(CFG_TMPL.format(classes=5, ann=ann, img=img_dir + "/"))
    with pytest.raises(ValueError, match="num_classes=5.*3 categories"):
        train_cli.main([str(cfg), "--device", "cpu", "--work-dir",
                        str(tmp_path / "work"), "--max-epochs", "1"])
    assert not (tmp_path / "work" / "metrics.jsonl").exists()

"""The training slice of the PyTorch port as a whole, on the CPU.

R18, 64x128, fp32, 7 classes, 5-dof boxes, ``max_gt`` 8, batch 2. Flax
variables are drawn once, every trivial leaf replaced by seeded numpy values,
and carried across with ``from_flax``; batches come from the synthetic
dataset through both loaders. Tolerances:

- batches from the two loaders: equal (``array_equal``);
- ``loss_cls`` / ``loss_bbox``: 1e-4 (fp32 networks that agree to 1e-4);
- gradients, leaf by leaf in the Flax layout through ``to_flax``:
  ``rtol=1e-3, atol=1e-5`` (sums over ~1.5k anchors in another order);
- parameters after two optimiser steps 1e-5, EMA 1e-6, frozen leaves bit-equal
  to their start, with the clip not biting (35) and biting (0.1);
- the learning rate: 1e-9 relative (both schedules compute in float32).

Both sides get the same anchor x gt overlaps: the JAX side's IoU call is
replaced by a callback into the port's, because low-quality matching compares
floats exactly and two IoU implementations 1e-7 apart pick different
candidates (``tests/test_torch_assign_loss.py`` says more, and holds the
overlaps themselves to 1e-4).
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sph_retina_tpu.data import DataLoader as JaxDataLoader
from sph_retina_tpu.data import SphPipeline as JaxPipeline
from sph_retina_tpu.data import make_synthetic_dataset as jax_synthetic
from sph_retina_tpu.engine.builder import build_tx as jax_build_tx
from sph_retina_tpu.engine.builder import scaled_base_lr as jax_scaled_base_lr
from sph_retina_tpu.engine import train as jtrain
from sph_retina_tpu.losses import sph_l1_loss as jax_l1
from sph_retina_tpu.models import SphRetinaNet as FlaxRetinaNet
from sph_retina_tpu.models import single_stage as jss
from sph_retina_tpu_torch import test as test_cli
from sph_retina_tpu_torch import train as train_cli
from sph_retina_tpu_torch.data import (
    DataLoader,
    SphPipeline,
    make_synthetic_dataset,
    prefetch_to_device,
    to_device,
)
from sph_retina_tpu_torch.engine.builder import (
    build_detector_config,
    build_tx,
    scaled_base_lr,
)
from sph_retina_tpu_torch.engine import train as ttrain
from sph_retina_tpu_torch.engine.runner import MetricLogger, run_training
from sph_retina_tpu_torch.engine.zoo import (
    RetinaNetFamily,
    make_generic_train_step,
)
from sph_retina_tpu_torch.losses import sph_l1_loss
from sph_retina_tpu_torch.models import single_stage as tss
from sph_retina_tpu_torch.models.from_flax import (
    from_flax,
    load_flax_variables,
    to_flax,
)
from sph_retina_tpu_torch.models.single_stage import SphRetinaNet

from test_torch_assign_loss import port_iou_callback
from test_torch_model import randomize

CLASSES, VERSION, H, W, MAX_GT, BATCH = 7, 5, 64, 128, 8, 2
CONFIG = "configs/sph_rotated_retinanet_r18_24e_spherebench.py"
FROZEN = ("backbone/conv1", "backbone/bn1", "backbone/layer1")


def _cfg(max_norm, lr):
    """The training keys both packages read; warm-up from a tenth of the
    base rate, so that two steps move the parameters visibly."""
    return {
        "model": {"num_classes": CLASSES, "box_version": VERSION,
                  "backbone": {"depth": 18, "frozen_stages": 1}},
        "img_size": (H, W), "bf16": False,
        "optimizer": {"lr": lr, "momentum": 0.9, "weight_decay": 5e-4},
        "optimizer_config": {"grad_clip": {"max_norm": max_norm}},
        "lr_config": {"step": [80, 110], "warmup_iters": 4,
                      "warmup_ratio": 0.1},
        "ema_momentum": 0.01,
    }


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def _assert_trees_close(got, want, **tol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _weight_per_box(loss):
    """L1 on decoded boxes gets one weight a box: spread it over the
    coordinates (the same wrapper on both sides)."""
    return lambda pred, target, weight, **kw: loss(
        pred, target, weight[:, None], **kw)


@pytest.fixture(scope="module")
def slice_():
    flax_model = FlaxRetinaNet(num_classes=CLASSES, box_version=VERSION,
                               depth=18, dtype=jnp.float32)
    variables = flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    rng = np.random.default_rng(0)
    params = randomize(jax.device_get(variables["params"]), rng)
    stats = randomize(jax.device_get(variables["batch_stats"]), rng)
    # the last batch norm of each residual block damped, so that activations
    # do not double a block (a stable net: gradient norm ~12, under the
    # configs' clip of 35), and the focal prior back in place (p ~ 0.01)
    for name, block in params["backbone"].items():
        if name.startswith("layer"):
            for bn in ("bn2", "downsample_bn"):
                if bn in block:
                    block[bn]["scale"] = block[bn]["scale"] * np.float32(0.3)
    params["bbox_head"]["retina_cls"]["bias"] = np.full(
        params["bbox_head"]["retina_cls"]["bias"].shape, -4.59512, np.float32)

    kwargs = dict(n_images=6, num_classes=CLASSES, img_size=(H, W),
                  box_version=VERSION)
    pipe = dict(img_size=(H, W), max_gt=MAX_GT, box_version=VERSION)
    jloader = JaxDataLoader(jax_synthetic(**kwargs), JaxPipeline(**pipe),
                            batch_size=BATCH, seed=3)
    tloader = DataLoader(make_synthetic_dataset(**kwargs), SphPipeline(**pipe),
                         batch_size=BATCH, seed=3)
    jbatches = [list(jloader.epoch(e)) for e in range(2)]
    tbatches = [list(tloader.epoch(e)) for e in range(2)]

    jcfg = jss.retina_config(CLASSES, box_version=VERSION, img_size=(H, W))
    tcfg = tss.retina_config(CLASSES, box_version=VERSION, img_size=(H, W))
    anchors = tcfg.flat_anchors()
    janchors = jcfg.flat_anchors()

    def jax_losses(cfg):
        def f(p, batch):
            cls, reg = flax_model.apply(
                {"params": p, "batch_stats": stats}, batch["images"])
            losses = jss.retina_loss(cfg, cls, reg, janchors,
                                     batch["gt_boxes"], batch["gt_labels"],
                                     batch["gt_mask"])
            return jtrain.total_loss(losses), losses
        return f

    with pytest.MonkeyPatch.context() as mp:
        # traced once, below, with the stand-in in place
        mp.setattr(jss, "_batch_pairwise_iou", port_iou_callback(anchors))
        jgrad = jax.jit(jax.value_and_grad(jax_losses(jcfg), has_aux=True))
        first = {k: jnp.asarray(v) for k, v in jbatches[0][0].items()
                 if k in ("images", "gt_boxes", "gt_labels", "gt_mask")}
        jgrad(params, first)
        decoded = {}
        for topk in (4, 64):
            cfg = jss.retina_config(
                CLASSES, box_version=VERSION, img_size=(H, W),
                loss_bbox=_weight_per_box(jax_l1), reg_decoded_bbox=True,
                loss_pos_topk=topk)
            decoded[topk] = jax.device_get(
                jax.jit(jax_losses(cfg))(params, first)[1])
    return dict(params=params, stats=stats, jbatches=jbatches,
                tbatches=tbatches, jcfg=jcfg, tcfg=tcfg, jgrad=jgrad,
                decoded=decoded)


def _torch_model(s):
    model = SphRetinaNet(num_classes=CLASSES, box_version=VERSION, depth=18,
                         dtype=torch.float32)
    load_flax_variables(model, s["params"], s["stats"])
    return model


def _jax_batch(batch):
    return {k: jnp.asarray(batch[k])
            for k in ("images", "gt_boxes", "gt_labels", "gt_mask")}


def _torch_batch(batch):
    return to_device({k: v for k, v in batch.items() if k != "img_id"},
                     torch.device("cpu"))


def test_both_loaders_yield_identical_batches(slice_):
    flipped = 0
    for jepoch, tepoch in zip(slice_["jbatches"], slice_["tbatches"]):
        assert len(jepoch) == len(tepoch) == 3
        for jb, tb in zip(jepoch, tepoch):
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape
                np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
            assert tb["images"].shape == (BATCH, H, W, 3)
            assert tb["gt_boxes"].shape == (BATCH, MAX_GT, VERSION)
            # padding rows are 1.0 everywhere
            assert (tb["gt_boxes"][~tb["gt_mask"]] == 1.0).all()
            flipped += int((tb["gt_boxes"][tb["gt_mask"]][:, 4] != 0).sum() > 0)
    assert flipped  # gamma carried (and negated on a flip) on both sides
    first, second = slice_["tbatches"]
    assert not np.array_equal(first[0]["img_id"], second[0]["img_id"]) \
        or not np.array_equal(first[0]["images"], second[0]["images"])


def test_loader_rejects_shards_and_pipeline_rejects_yuv():
    """Shards raise; ``yuv420`` without ``normalize_on_device`` raises the
    JAX package's ``ValueError`` (the conversion runs in the step)."""
    ds = make_synthetic_dataset(n_images=4)
    with pytest.raises(NotImplementedError, match="num_shards"):
        DataLoader(ds, SphPipeline(), num_shards=2)
    with pytest.raises(ValueError, match="normalize_on_device"):
        SphPipeline(transfer_colorspace="yuv420")
    u8 = SphPipeline(img_size=(H, W), normalize_on_device=True)(
        ds[0], np.random.default_rng(0))
    assert u8["images"].dtype == np.uint8
    order = [b["img_id"].tolist() for b in prefetch_to_device(
        DataLoader(ds, SphPipeline(img_size=(H, W)), batch_size=1,
                   shuffle=False).epoch(0), lambda b: b, depth=2)]
    assert order == [[0], [1], [2], [3]]


def test_losses_and_gradients_equal(slice_):
    batch = slice_["tbatches"][0][0]
    (jtotal, jlosses), jgrads = slice_["jgrad"](slice_["params"],
                                                _jax_batch(batch))
    model = _torch_model(slice_)
    loss = RetinaNetFamily.loss_fn(model, slice_["tcfg"])
    total, losses = loss(_torch_batch(batch))
    assert set(losses) == {"loss_cls", "loss_bbox"}
    for k in losses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(total), float(jtotal), atol=2e-4, rtol=0)
    assert float(losses["loss_cls"]) > 0 and float(losses["loss_bbox"]) > 0

    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    got, no_stats = to_flax(grads)
    assert no_stats == {}
    _assert_trees_close(got, jax.device_get(jgrads), rtol=1e-3, atol=1e-5)
    head = got["bbox_head"]["retina_reg"]["kernel"]
    assert np.abs(head).sum() > 0


@pytest.mark.parametrize("topk", [4, 64])
def test_decoded_box_loss_with_the_positive_gather(slice_, topk):
    """``reg_decoded_bbox`` + L1 + ``loss_pos_topk``. With K above the
    positives the gather is exact and the losses agree; with K = 4 positives
    are dropped, both sides count the same number, and the regression loss
    is not compared (which of several weight-1 rows a top-k keeps is each
    library's choice)."""
    batch = slice_["tbatches"][0][0]
    want = slice_["decoded"][topk]
    cfg = tss.retina_config(
        CLASSES, box_version=VERSION, img_size=(H, W),
        loss_bbox=_weight_per_box(sph_l1_loss), reg_decoded_bbox=True,
        loss_pos_topk=topk)
    model = _torch_model(slice_)
    _, got = RetinaNetFamily.loss_fn(model, cfg)(_torch_batch(batch))
    assert set(got) == set(want) == {"loss_cls", "loss_bbox",
                                     "metric_pos_dropped"}
    assert float(got["metric_pos_dropped"]) == float(want["metric_pos_dropped"])
    np.testing.assert_allclose(float(got["loss_cls"]), float(want["loss_cls"]),
                               atol=1e-4, rtol=0)
    assert not got["metric_pos_dropped"].requires_grad
    if topk == 4:
        assert float(got["metric_pos_dropped"]) > 0
    else:
        assert float(got["metric_pos_dropped"]) == 0
        # decoded boxes are degrees: 1e-4 relative to a loss of order 10
        np.testing.assert_allclose(float(got["loss_bbox"]),
                                   float(want["loss_bbox"]), rtol=1e-4)
    assert float(ttrain.total_loss(got)) == pytest.approx(
        float(got["loss_cls"]) + float(got["loss_bbox"]))


@pytest.mark.parametrize("max_norm, lr", [(35.0, 0.01), (0.1, 1.0)],
                         ids=["clip_idle", "clip_bites"])
def test_two_optimiser_steps_equal(slice_, max_norm, lr):
    """The clipped case runs at a base rate of 1.0: gradients cut to a norm
    of 0.1 would otherwise move nothing that the tolerance could see."""
    cfg = _cfg(max_norm, lr)
    batches = slice_["tbatches"][0][:2]

    tx = jax_build_tx(cfg, steps_per_epoch=3)
    params = slice_["params"]
    opt_state = tx.init(params)
    norms = []
    for batch in batches:
        _, grads = slice_["jgrad"](params, _jax_batch(batch))
        trainable = [g for k, g in _leaves(jax.device_get(grads))
                     if not k.startswith(FROZEN)]
        norms.append(float(np.sqrt(sum((g ** 2).sum() for g in trainable))))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    # the case is what its name says
    assert all(n > max_norm for n in norms) == (max_norm == 0.1)
    assert all(n < max_norm for n in norms) == (max_norm == 35.0)

    model = _torch_model(slice_)
    tcfg = build_detector_config(cfg)
    optimizer = build_tx(cfg, model, steps_per_epoch=3)
    assert sorted(optimizer.frozen_names) == sorted(
        n for n, _ in model.named_parameters()
        if n.replace(".", "/").startswith(FROZEN))
    assert len(optimizer.frozen_names) == 3 + 2 * 6  # stem + 2 basic blocks
    # the two ways to a train step, one a case
    if max_norm == 35.0:
        step = make_generic_train_step(RetinaNetFamily, model, tcfg, optimizer)
    else:
        step = ttrain.make_train_step(model, tcfg, optimizer, tss.retina_loss)
    lrs = []
    for batch in batches:
        metrics = step(_torch_batch(batch))
        lrs.append(optimizer.last_lr)
        assert set(metrics) == {"loss", "loss_cls", "loss_bbox"}
        assert all(v.ndim == 0 and not v.requires_grad
                   for v in metrics.values())
    assert optimizer.count == 2
    np.testing.assert_allclose(lrs, [lr * 0.1, lr * (0.1 + 0.9 / 4)],
                               rtol=1e-6)

    got, got_stats = to_flax(model.state_dict())
    _assert_trees_close(got, jax.device_get(params), atol=1e-5, rtol=0)
    _assert_trees_close(got_stats, slice_["stats"], atol=0, rtol=0)
    start = dict(_leaves(slice_["params"]))
    moved = 0.0
    for k, v in _leaves(got):
        if k.startswith(FROZEN):
            np.testing.assert_array_equal(v, start[k], err_msg=k)
        else:
            moved = max(moved, float(np.abs(v - start[k]).max()))
    assert moved > 1e-4  # the steps did something the tolerance can see

    ema, _ = to_flax(optimizer.ema_state_dict())
    want_ema = jax.device_get(jtrain.get_ema_params(opt_state))
    _assert_trees_close(ema, want_ema, atol=1e-6, rtol=0)
    ema_moved = max(float(np.abs(v - start[k]).max())
                    for k, v in _leaves(ema))
    assert 0 < ema_moved < moved


def test_learning_rate_schedule_equals_optax():
    cfg = {"optimizer": {"lr": 0.005}, "data": {"samples_per_gpu": 4},
           "auto_scale_lr": {"enable": True, "base_batch_size": 8}}
    spe = 37
    assert scaled_base_lr(cfg) == jax_scaled_base_lr(cfg) == 0.0025
    assert scaled_base_lr(cfg, 4) == jax_scaled_base_lr(cfg, 4)
    want = jtrain.step_lr_schedule(0.0025, spe)
    model = torch.nn.Conv2d(1, 1, 1)
    got = build_tx(cfg, model, steps_per_epoch=spe).schedule
    for count in (0, 1, 499, 500, 80 * spe - 1, 80 * spe, 110 * spe,
                  120 * spe):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-9,
                                   err_msg=str(count))
    assert got(0) == pytest.approx(0.0025 * 0.001)
    assert got(110 * spe) == pytest.approx(0.0025 * 0.01)


def test_build_tx_reads_the_ema_hook_and_explicit_prefixes():
    model = SphRetinaNet(num_classes=2, depth=18, dtype=torch.float32)
    opt = build_tx(
        {"custom_hooks": [{"type": "EMAHook"}],
         "frozen_prefixes": ["neck"], "optimizer_config": {}}, model, 1)
    assert opt.ema_momentum == 0.0002 and opt.grad_clip is None
    assert all(n.startswith("neck.") for n in opt.frozen_names)
    assert opt.frozen_names and not model.neck.lateral_0.weight.requires_grad
    with pytest.raises(RuntimeError, match="no gradient"):
        opt.step()
    none = build_tx({"model": {"backbone": {"frozen_stages": -1}}},
                             model, 1)
    assert none.frozen_names == [] and none.ema_state_dict() is None


def test_to_flax_is_the_inverse_of_from_flax(slice_):
    state = from_flax(slice_["params"], slice_["stats"])
    params, stats = to_flax(state)
    _assert_trees_close(params, slice_["params"], atol=0, rtol=0)
    _assert_trees_close(stats, slice_["stats"], atol=0, rtol=0)
    again = from_flax(params, stats)
    assert again.keys() == state.keys()
    assert all(torch.equal(again[k], state[k]) for k in state)
    with pytest.raises(KeyError, match="unknown state_dict entry"):
        to_flax({"backbone.conv1.weight": torch.zeros((2, 2, 2))})


def test_trainer_cli_writes_finite_metrics(tmp_path, monkeypatch, capsys):
    # no TensorBoard writer: importing it costs ten seconds here
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    work = tmp_path / "run"
    assert train_cli.main([
        CONFIG, "--synthetic", "--device", "cpu", "--max-epochs", "1",
        "--work-dir", str(work), "--seed", "1", "--cfg-options",
        "img_size=(64,128)", "bf16=False", "data.samples_per_gpu=2",
        "data.n_synthetic=6", "log_config.interval=1",
        "model.loss_bbox={'type':'L1Loss'}", "model.reg_decoded_bbox=False",
    ]) == 0
    assert "training done" in capsys.readouterr().out
    records = [json.loads(line)
               for line in (work / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3]
    for r in train:
        assert all(np.isfinite(r[k]) for k in ("loss", "loss_cls", "loss_bbox"))
        assert r["loss"] == pytest.approx(r["loss_cls"] + r["loss_bbox"],
                                          rel=1e-5)
    assert records[-1]["prefix"] == "epoch" and records[-1]["epoch"] == 0


@pytest.mark.parametrize("cli, argv, match", [
    # resuming works now; a resumed run across processes still refuses
    (train_cli, [CONFIG, "--synthetic", "--device", "cpu", "--resume-from",
                 "x", "--launcher", "torch"], "--launcher"),
    (train_cli, [CONFIG, "--synthetic", "--device", "cpu", "--load-backbone",
                 "x"], "--load-backbone"),
    (train_cli, [CONFIG, "--synthetic", "--device", "cpu", "--launcher",
                 "torch"], "--launcher"),
    # training on the config's annotation files works now; with a backbone
    # to load it still refuses, before reading them
    (train_cli, [CONFIG, "--device", "cpu", "--load-backbone", "x"],
     "--load-backbone"),
    # the evaluation CLI's raw results for the analysis tools
    (test_cli, [CONFIG, "x", "--device", "cpu", "--save-raw", "raw.npz"],
     "--save-raw"),
], ids=["resume", "load_backbone", "launcher", "annotation_file",
        "iou_loss_of_the_config"])
def test_trainer_cli_refuses_by_name(cli, argv, match, tmp_path):
    if cli is train_cli:
        argv = argv + ["--work-dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv)


def test_trainer_cli_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main([CONFIG, "--synthetic", "--work-dir", str(tmp_path)])


def test_run_training_raises_on_a_nan_loss(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    class Counter:
        count = 0

    loader = DataLoader(make_synthetic_dataset(n_images=4),
                        SphPipeline(img_size=(H, W)), batch_size=2)
    losses = iter([1.0, float("nan")])
    logger = MetricLogger(str(tmp_path), interval=1)
    try:
        with pytest.raises(FloatingPointError, match="step 2"):
            run_training(
                train_step=lambda b: {"loss": torch.tensor(next(losses))},
                optimizer=Counter(), loader=loader, max_epochs=1,
                logger=logger)
        with pytest.raises(ValueError, match="checkpointer needs the model"):
            run_training(train_step=None, optimizer=Counter(), loader=loader,
                         max_epochs=1, logger=logger, checkpointer=object())
    finally:
        logger.close()
    records = [json.loads(line) for line in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["prefix"] for r in records] == ["train", "error"]

"""The IoU-family losses of the PyTorch port vs the JAX package, on the CPU.

``Sph2PobIoULoss`` in its four modes, ``SphIoULoss`` and ``Sph2PobL1Loss`` on
values and gradients; ``build_loss`` of the three types; ``retina_loss`` with
``reg_decoded_bbox=True`` and the CIoU loss; two steps of the trainer on the
Sphere-bench config (decoded-box Sph2Pob-CIoU) at a small image size. The
same numpy inputs, made from a seed, go through both packages. The JAX losses
run eagerly: XLA on the CPU takes ~100 s to compile the gradient of the
rotated-box IoU, the eager gradient ~3 s. Tolerances:

- loss values: 1e-4 (the JAX suite's own);
- gradients: 1e-4 absolute on seeded pairs that overlap, away from the
  clamps; on identical and zero-area pairs the gradients are finite;
- ``retina_loss``: ``loss_cls`` and ``loss_bbox`` 1e-4, on the same anchor x
  gt overlaps (``tests/test_torch_assign_loss.py:port_iou_callback``: the
  assigner compares floats exactly), with the config's positive gather and
  fewer positives than it keeps, where it is exact. The network's outputs
  are seeded numpy arrays of the R18 head's shapes at 64x128 (the network
  itself is held to the JAX package in ``tests/test_torch_model.py``).
"""

import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.losses import iou_loss as jiou
from sph_retina_tpu.losses import l1_loss as jl1
from sph_retina_tpu.models import single_stage as jss
from sph_retina_tpu_torch import losses as tlosses
from sph_retina_tpu_torch import train as train_cli
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.losses import iou_loss as tiou
from sph_retina_tpu_torch.losses import l1_loss as tl1
from sph_retina_tpu_torch.models import single_stage as tss

from test_torch_assign_loss import port_iou_callback

TOL = 1e-4
MODES = ("iou", "giou", "diou", "ciou")
K = 24
CONFIG = "configs/sph_retinanet_r18_fpn_24e_spherebench.py"


def _pairs(d, seed=0):
    """Predictions near their targets (the regression regime: IoU 0.2-0.9)
    with seeded per-box weights."""
    rng = np.random.default_rng(seed)
    target = generate_boxes(K, d, seed=seed + 1, fov_range=(10.0, 60.0),
                            phi_range=(20.0, 160.0))
    pred = target + rng.normal(0, 3.0, target.shape).astype(np.float32)
    weight = rng.uniform(0.2, 1.0, K).astype(np.float32)
    return pred.astype(np.float32), target, weight


def _loss_fns(name, mode):
    """(JAX loss, port loss) of one case, each ``f(pred, target, weight)``."""
    if name == "Sph2PobIoULoss":
        kw = dict(mode=mode, avg_factor=7.0)
        return (lambda *a: jiou.sph2pob_iou_loss(*a, **kw),
                lambda *a: tiou.sph2pob_iou_loss(*a, **kw))
    if name == "SphIoULoss":
        return jiou.sph_iou_loss, tiou.sph_iou_loss
    # one weight a coordinate, as the L1 family takes them
    return (lambda p, t, w: jl1.sph2pob_l1_loss(
        p, t, jnp.broadcast_to(w[:, None], t.shape)),
        lambda p, t, w: tl1.sph2pob_l1_loss(p, t, w[:, None].expand_as(t)))


CASES = [("Sph2PobIoULoss", m) for m in MODES] + [
    ("SphIoULoss", None), ("Sph2PobL1Loss", None)]
CASE_IDS = [f"{n}-{m}" if m else n for n, m in CASES]


@pytest.fixture(scope="module")
def jax_values_and_grads():
    """{(name, mode): (value, d value / d pred)} at D = 4, eagerly."""
    out = {}
    pred, target, weight = (jnp.asarray(a) for a in _pairs(4))
    for name, mode in CASES:
        v, g = jax.value_and_grad(_loss_fns(name, mode)[0])(pred, target,
                                                            weight)
        out[name, mode] = float(v), np.asarray(g)
    return out


@pytest.mark.parametrize("name, mode", CASES, ids=CASE_IDS)
def test_losses_and_gradients_equal_the_jax_packages(jax_values_and_grads,
                                                     name, mode):
    pred, target, weight = (torch.from_numpy(a) for a in _pairs(4))
    pred.requires_grad_(True)
    value = _loss_fns(name, mode)[1](pred, target, weight)
    want, want_grad = jax_values_and_grads[name, mode]
    assert value.shape == () and 0.0 < float(value) < 10.0
    assert float(value) == pytest.approx(want, abs=TOL)
    value.backward()
    np.testing.assert_allclose(pred.grad.numpy(), want_grad, atol=TOL, rtol=0)
    assert float(pred.grad.abs().sum()) > 0


@pytest.mark.parametrize("name, mode", CASES, ids=CASE_IDS)
def test_degenerate_pairs_give_finite_gradients(name, mode):
    """Identical pairs (the jitter's case) and boxes of zero extent."""
    target = generate_boxes(6, 4, seed=3)
    zero = target.copy()
    zero[:, 2:4] = 0.0
    pred = torch.from_numpy(np.concatenate([target, zero]))
    pred.requires_grad_(True)
    tgt = torch.from_numpy(np.concatenate([target, zero]))
    value = _loss_fns(name, mode)[1](pred, tgt, torch.ones(12))
    assert torch.isfinite(value)
    value.backward()
    assert torch.isfinite(pred.grad).all()


def test_per_pair_terms_of_the_four_modes():
    """``reduction='none'`` of each mode on rotated (5-dof) boxes, pair by
    pair: CIoU against the JAX package's, and the order that the penalties
    put the four in: iou <= giou, iou <= diou <= ciou."""
    pred, target, _ = (torch.from_numpy(a) for a in _pairs(5, seed=5))
    terms = {m: tiou.sph2pob_iou_loss(pred, target, mode=m, reduction="none")
             for m in MODES}
    want = jiou.sph2pob_iou_loss(jnp.asarray(pred.numpy()),
                                 jnp.asarray(target.numpy()), mode="ciou",
                                 reduction="none")
    assert terms["ciou"].shape == (K,)
    np.testing.assert_allclose(terms["ciou"].numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    assert (terms["iou"] <= terms["giou"] + 1e-6).all()
    assert (terms["iou"] <= terms["diou"] + 1e-6).all()
    assert (terms["diou"] <= terms["ciou"] + 1e-6).all()
    assert float((terms["ciou"] - terms["iou"]).max()) > 0
    with pytest.raises(ValueError, match="mode"):
        tiou.sph2pob_iou_loss(pred, target, mode="piou")


def test_build_loss_of_the_iou_family():
    pred, target, weight = (torch.from_numpy(a) for a in _pairs(4))
    per_coordinate = weight[:, None].expand_as(target)
    for cfg, fn, kwargs, w in [
            (dict(type="Sph2PobIoULoss", mode="ciou", loss_weight=2.0),
             tiou.sph2pob_iou_loss, dict(mode="ciou", loss_weight=2.0),
             weight),
            (dict(type="SphIoULoss", iou_calculator="unbiased_iou"),
             tiou.sph_iou_loss, dict(iou_calculator="unbiased_iou"), weight),
            (dict(type="Sph2PobL1Loss", transform="sph2pob_efficient"),
             tl1.sph2pob_l1_loss, dict(transform="sph2pob_efficient"),
             per_coordinate)]:
        built = tlosses.build_loss(cfg)
        assert built.func is fn and built.keywords == kwargs
        torch.testing.assert_close(built(pred, target, w),
                                   fn(pred, target, w, **kwargs))
    # the Gaussian and Kent types build too (tests/test_torch_gaussian_loss.py)
    for kind in ("Sph2PobKLDLoss", "KentLoss"):
        assert callable(tlosses.build_loss({"type": kind}))


def test_obb2delta_and_the_angle_wrap():
    rng = np.random.default_rng(9)
    p = rng.uniform(0.1, 2.0, (16, 5)).astype(np.float32)
    g = rng.uniform(0.1, 2.0, (16, 5)).astype(np.float32)
    p[:, 4] -= 3.0  # negative angles: floor-mod, not fmod
    for modifier in ("original", "modulus"):
        np.testing.assert_allclose(
            tl1.obb2delta(torch.from_numpy(p), torch.from_numpy(g),
                          modifier).numpy(),
            np.asarray(jl1.obb2delta(jnp.asarray(p), jnp.asarray(g),
                                     modifier)), atol=1e-5, rtol=0)
    out = tl1.sph2pob_l1_loss(*(torch.from_numpy(a) for a in _pairs(5)[:2]),
                              encode=False, swap=True)
    want = jl1.sph2pob_l1_loss(*(jnp.asarray(a) for a in _pairs(5)[:2]),
                               encode=False, swap=True)
    assert float(out) == pytest.approx(float(want), abs=TOL)


# --------------------------------------------------------------------------- #
# retina_loss with decoded boxes and the CIoU loss
# --------------------------------------------------------------------------- #
CLASSES, H, W, B, G = 12, 64, 128, 2, 4


def _head_outputs(cfg, seed):
    """Seeded per-level (B, n_l, C) logits and (B, n_l, 4) deltas."""
    rng = np.random.default_rng(seed)
    cls, reg = [], []
    for h, w in cfg.featmap_sizes():
        n = h * w * 9
        cls.append(rng.normal(-3.0, 1.5, (B, n, CLASSES)).astype(np.float32))
        reg.append(rng.normal(0.0, 0.2, (B, n, 4)).astype(np.float32))
    return cls, reg


def _gts(seed):
    boxes = np.stack([generate_boxes(G, 4, seed=seed + i,
                                     fov_range=(15.0, 60.0),
                                     phi_range=(30.0, 150.0))
                      for i in range(B)])
    labels = np.random.default_rng(seed).integers(
        0, CLASSES, (B, G)).astype(np.int32)
    mask = np.array([[True] * G, [True] * (G - 1) + [False]])
    boxes[~mask] = 1.0  # the pipeline's padding
    return boxes, labels, mask


def test_retina_loss_with_decoded_ciou_equals_the_jax_packages(monkeypatch):
    """With the config's positive gather (K = 1024 an image), which is exact
    while the positives are fewer than K."""
    kw = dict(img_size=(H, W), reg_decoded_bbox=True, loss_pos_topk=1024)
    tcfg = tss.retina_config(CLASSES, loss_bbox=tlosses.build_loss(
        {"type": "Sph2PobIoULoss", "mode": "ciou"}), **kw)
    jcfg = jss.retina_config(CLASSES, loss_bbox=lambda *a, **k:
                             jiou.sph2pob_iou_loss(*a, mode="ciou", **k), **kw)
    anchors = tcfg.flat_anchors()
    monkeypatch.setattr(jss, "_batch_pairwise_iou", port_iou_callback(anchors))
    cls, reg = _head_outputs(tcfg, seed=1)
    gts = _gts(seed=2)

    want = jax.jit(lambda c, r, *g: jss.retina_loss(
        jcfg, c, r, jcfg.flat_anchors(), *g))(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
        *(jnp.asarray(a) for a in gts))
    treg = [torch.from_numpy(r).requires_grad_(True) for r in reg]
    got = tss.retina_loss(tcfg, [torch.from_numpy(c) for c in cls], treg,
                          anchors, *(torch.from_numpy(a) for a in gts))
    assert set(got) == set(want)
    num_pos = int(tss.anchor_targets(
        tcfg, anchors, *(torch.from_numpy(a) for a in gts)).num_pos)
    assert 0 < num_pos < B * 1024
    for k in ("loss_cls", "loss_bbox"):
        assert float(got[k]) == pytest.approx(float(want[k]), abs=TOL)
    assert 0.0 < float(got["loss_bbox"]) < 2.0
    assert float(got["metric_pos_dropped"]) == 0.0
    got["loss_bbox"].backward()
    grads = torch.cat([r.grad.flatten() for r in treg])
    assert torch.isfinite(grads).all() and float(grads.abs().sum()) > 0


def test_the_assigner_runs_every_available_backend():
    """``sph2pob_efficient`` through the fused pairwise path, the others
    through ``sph_overlaps``, ``kent`` too."""
    cfg = tss.retina_config(CLASSES, img_size=(H, W))
    anchors = cfg.flat_anchors()[:300]
    gt = torch.from_numpy(_gts(seed=4)[0])
    fused = tss._batch_pairwise_iou(gt, anchors, "sph2pob_efficient")
    plain = tss._batch_pairwise_iou(gt, anchors, "sph2pob_standard")
    assert tuple(fused.shape) == tuple(plain.shape) == (B, G, 300)
    assert float(fused.max()) > 0.1
    np.testing.assert_allclose(
        tss._batch_pairwise_iou(gt, anchors, "sph2pob_efficient_iou").numpy(),
        fused.numpy())
    for backend in ("unbiased_iou", "naive_iou", "sph", "fov",
                    "sph2pob_legacy", "kent"):
        out = tss._batch_pairwise_iou(gt, anchors, backend)
        assert tuple(out.shape) == (B, G, 300) and torch.isfinite(out).all()


@pytest.fixture
def emptied_tmp_path(tmp_path):
    """``tmp_path``, emptied once the test is done with it: the trainer
    writes a checkpoint of ~150-230 MB there."""
    yield tmp_path
    for path in tmp_path.iterdir():
        if path.is_dir():
            shutil.rmtree(path, ignore_errors=True)
        else:
            path.unlink()


@pytest.mark.usefixtures("emptied_tmp_path")
def test_the_trainer_takes_two_steps_on_the_ciou_config(tmp_path,
                                                        monkeypatch, capsys):
    """The shipped Sphere-bench config (R18, decoded-box Sph2Pob-CIoU,
    ``sph2pob_efficient`` assignment) through ``train.main`` at 64x128."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    work = tmp_path / "run"
    assert train_cli.main([
        CONFIG, "--synthetic", "--device", "cpu", "--max-epochs", "1",
        "--work-dir", str(work), "--cfg-options", "img_size=(64,128)",
        "bf16=False", "data.samples_per_gpu=2", "data.n_synthetic=4",
        "data.max_gt=8", "log_config.interval=1"]) == 0
    assert "training done" in capsys.readouterr().out
    records = [json.loads(line)
               for line in (work / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if r["prefix"] == "train"]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert all(np.isfinite(r[k]) for k in ("loss", "loss_cls",
                                               "loss_bbox"))
        assert 0.0 < r["loss_bbox"] < 2.0  # 1 - CIoU terms, mean over pos
        assert r["metric_pos_dropped"] == 0.0

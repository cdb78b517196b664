"""The FCOS family of the PyTorch port vs the JAX package, on the CPU.

R18-FCOS at 64x128 in fp32, the Flax variables (seeded non-trivial biases,
GroupNorm and batch-norm parameters, per-level scales) carried across by
``from_flax``; the same numpy inputs go through both packages. Tolerances:

- network outputs: 1e-4 absolute + 1e-4 relative (fp32 convolutions and
  GroupNorm statistics summed in another order);
- ``fcos_targets``: labels equal, distances 1e-4 (pixels, up to 128),
  centerness 1e-5, with and without centre sampling, 4- and 5-dof;
- ``fcos_loss``: the three losses and their gradients with respect to the
  head's outputs 1e-4 (the decoded-box Sph2Pob IoU loss of the shipped
  indoor360 config, on every point);
- ``fcos_predict``: the kept boxes, scores and labels equal within 1e-5 on
  seeded head outputs without ties (the JAX package's two-stage
  ``approx_max_k`` top-k is exact on the CPU; the port's is exact);
- the two shipped FCOS configs, narrowed by ``--cfg-options``, build
  through ``get_family`` and take one step on the CPU.

The JAX network and predictions are jitted once; the loss runs eagerly.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.losses import iou_loss as jiou
from sph_retina_tpu.models import fcos as jfcos
from sph_retina_tpu_torch import train as train_cli
from sph_retina_tpu_torch.data import to_device
from sph_retina_tpu_torch.engine.zoo import get_family
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.losses import iou_loss as tiou
from sph_retina_tpu_torch.models import fcos as tfcos
from sph_retina_tpu_torch.models.from_flax import (
    from_flax,
    load_flax_variables,
    to_flax,
)
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config

from test_torch_model import randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES, H, W = 3, 64, 128
ATOL = 1e-4


def one_cpu_step(config: str, extra=()):
    """A shipped config narrowed to R18 (where it has a ResNet), 64x128,
    fp32, batch 2, max_gt 8: built through ``get_family`` as the trainer
    builds it, one optimiser step on a synthetic batch on the CPU. Returns
    (model, detector config, the step's metrics as floats, all finite)."""
    cfg = apply_overrides(load_config(os.path.join(REPO, "configs", config)), [
        "img_size=(64,128)", "bf16=False", "data.n_synthetic=2",
        "data.samples_per_gpu=2", "data.max_gt=8", *extra])
    if cfg["model"].get("type") != "SphSSD":
        cfg = apply_overrides(cfg, ["model.backbone.depth=18"])
    assert get_family(cfg).name == cfg["model"].get("type", "SphRetinaNet")
    model, det_cfg, loader, optimizer, step = train_cli.build_training(
        cfg, torch.device("cpu"))
    (batch,) = list(loader.epoch(0))
    metrics = step(to_device({k: v for k, v in batch.items()
                              if k != "img_id"}, torch.device("cpu")))
    metrics = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert optimizer.count == 1
    return model, det_cfg, metrics


@pytest.fixture(scope="module")
def nets():
    flax_model = jfcos.SphFCOS(num_classes=CLASSES, depth=18,
                               dtype=jnp.float32)
    variables = jax.jit(flax_model.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, H, W, 3)))
    rng = np.random.default_rng(0)
    params = randomize(jax.device_get(variables["params"]), rng)
    stats = randomize(jax.device_get(variables["batch_stats"]), rng)
    model = tfcos.SphFCOS(num_classes=CLASSES, depth=18,
                          dtype=torch.float32).eval()
    load_flax_variables(model, params, stats)
    return flax_model, params, stats, model


def test_from_flax_carries_every_leaf(nets):
    _, params, stats, model = nets
    state = from_flax(params, stats)
    assert set(state) == set(model.state_dict())
    assert tuple(state["bbox_head.scale_3.weight"].shape) == ()
    assert tuple(state["bbox_head.cls_gn_0.weight"].shape) == (256,)
    back, back_stats = to_flax(state)
    for path in (("bbox_head", "scale_3", "scale"),
                 ("bbox_head", "reg_gn_2", "bias"),
                 ("bbox_head", "conv_centerness", "kernel")):
        a, b = back, params
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back_stats["backbone"]["bn1"]["var"],
                                  stats["backbone"]["bn1"]["var"])


def test_network_matches_flax(nets):
    flax_model, params, stats, model = nets
    images = np.random.default_rng(1).normal(0, 1, (2, H, W, 3)).astype(
        np.float32)
    want = jax.jit(flax_model.apply)({"params": params, "batch_stats": stats},
                                     jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    sizes = tfcos.fcos_config(CLASSES, img_size=(H, W)).featmap_sizes()
    for lvl, (h, w) in enumerate(sizes):
        assert tuple(got[0][lvl].shape) == (2, h * w, CLASSES)
        assert tuple(got[1][lvl].shape) == (2, h * w, 4)
        assert tuple(got[2][lvl].shape) == (2, h * w)
    for g_out, w_out in zip(got, want):
        for g, w in zip(g_out, w_out):
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=1e-4)


def _gts(seed, d, b=2, g=6):
    rng = np.random.default_rng(seed)
    boxes = np.stack([generate_boxes(g, d, seed=seed + i,
                                     fov_range=(5.0, 120.0),
                                     phi_range=(30.0, 150.0))
                      for i in range(b)])
    labels = rng.integers(0, CLASSES, (b, g)).astype(np.int32)
    mask = np.arange(g)[None, :] < np.array([[5], [3]])
    return boxes, labels, mask


@pytest.mark.parametrize("d, center_sampling", [(4, False), (5, False),
                                                (4, True)])
def test_fcos_targets_equal_the_jax_packages(d, center_sampling):
    kw = dict(img_size=(H, W), box_version=d, center_sampling=center_sampling)
    jcfg, tcfg = jfcos.fcos_config(CLASSES, **kw), tfcos.fcos_config(
        CLASSES, **kw)
    boxes, labels, mask = _gts(seed=d, d=d)
    want = jax.jit(lambda *a: jfcos.fcos_targets(jcfg, *a))(
        jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
    got = tfcos.fcos_targets(tcfg, torch.from_numpy(boxes),
                             torch.from_numpy(labels), torch.from_numpy(mask))
    assert got.labels.dtype == torch.int32
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels.numpy() < CLASSES).sum() > 10
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.centerness.numpy(),
                               np.asarray(want.centerness), atol=1e-5, rtol=0)
    for g, w in zip(tcfg.level_points(), jcfg.level_points()):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _head_outputs(seed, b=2, d=4):
    rng = np.random.default_rng(seed)
    sizes = tfcos.fcos_config(CLASSES, img_size=(H, W)).featmap_sizes()
    cls = [rng.normal(0, 2.0, (b, h * w, CLASSES)).astype(np.float32)
           for h, w in sizes]
    reg = [np.exp(rng.normal(2.5, 0.7, (b, h * w, d))).astype(np.float32)
           for h, w in sizes]
    ctr = [rng.normal(0, 1.0, (b, h * w)).astype(np.float32)
           for h, w in sizes]
    return cls, reg, ctr


@pytest.mark.parametrize("d", [4, 5])
def test_fcos_loss_and_gradients_equal_the_jax_packages(d):
    kw = dict(img_size=(H, W), box_version=d)
    jcfg = jfcos.fcos_config(CLASSES, loss_bbox=functools.partial(
        jiou.sph2pob_iou_loss, mode="iou"), **kw)
    tcfg = tfcos.fcos_config(CLASSES, loss_bbox=functools.partial(
        tiou.sph2pob_iou_loss, mode="iou"), **kw)
    outs = _head_outputs(seed=7 + d, d=d)
    if d == 5:  # the gamma channel of a 5-dof head is an angle in degrees
        for r in outs[1]:
            r[..., 4] = np.log(r[..., 4])
    boxes, labels, mask = _gts(seed=9, d=d)
    gt = (boxes, labels, mask)

    def jax_total(*outs_):
        out = jfcos.fcos_loss(jcfg, *outs_, *(jnp.asarray(a) for a in gt))
        return sum(out.values()), out

    (_, want), grads = jax.value_and_grad(
        jax_total, argnums=(0, 1, 2), has_aux=True)(
        *([jnp.asarray(a) for a in o] for o in outs))
    t_outs = [[torch.from_numpy(a).requires_grad_(True) for a in o]
              for o in outs]
    got = tfcos.fcos_loss(tcfg, *t_outs, *(torch.from_numpy(a) for a in gt))
    assert set(got) == set(want) == {"loss_cls", "loss_bbox",
                                     "loss_centerness"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=1e-5, err_msg=k)
    sum(got.values()).backward()
    for t_list, j_list in zip(t_outs, grads):
        for t, j in zip(t_list, j_list):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       atol=ATOL, rtol=1e-4)


def test_fcos_predict_equals_the_jax_packages():
    cfg_kw = dict(img_size=(H, W), nms_pre=50, max_per_img=30)
    jcfg = jfcos.fcos_config(CLASSES, **cfg_kw)
    tcfg = tfcos.fcos_config(CLASSES, **cfg_kw)
    outs = _head_outputs(seed=11)
    want = jax.jit(lambda *o: jfcos.fcos_predict(jcfg, *o))(
        *([jnp.asarray(a) for a in o] for o in outs))
    got = tfcos.fcos_predict(tcfg, *([torch.from_numpy(a) for a in o]
                                     for o in outs))
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum(1).min() > 10
    np.testing.assert_array_equal(got.labels.numpy()[gv],
                                  np.asarray(want.labels)[wv])
    np.testing.assert_allclose(got.scores.numpy()[gv],
                               np.asarray(want.scores)[wv], atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy()[gv],
                               np.asarray(want.boxes)[wv], atol=1e-4)


@pytest.mark.parametrize("config", ["sph_fcos_r50_fpn_120e_indoor360.py",
                                    "sph_fcos_r18_fpn_24e_spherebench.py"])
def test_shipped_config_builds_and_takes_one_cpu_step(config):
    model, det_cfg, metrics = one_cpu_step(config)
    assert isinstance(model, tfcos.SphFCOS)
    assert det_cfg.loss_bbox.func is tiou.sph2pob_iou_loss
    assert det_cfg.nms_backend == "planar"
    assert set(metrics) == {"loss", "loss_cls", "loss_bbox",
                            "loss_centerness"}

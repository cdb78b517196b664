"""The SSD-VGG16 family of the PyTorch port vs the JAX package, on the CPU.

SSD-VGG16 at 64x128 in fp32, the Flax variables (seeded non-trivial biases
and scales) carried across by ``from_flax``; the same numpy inputs go
through both packages. Tolerances:

- network outputs: 1e-4 absolute + 1e-4 relative (fp32 convolutions summed
  in another order, as ``tests/test_torch_model.py``), also on an odd-sized
  72x136 input, where the ceil-mode pools pad a ragged edge;
- ``ssd_loss``: the values and their gradients with respect to the head's
  outputs 1e-4, on seeded head outputs and on the same anchor x gt overlaps
  (the port's fused IoU fed to the JAX side: the assigner compares floats
  exactly, ROADMAP C3), smooth-L1 on deltas and the decoded-box Sph2Pob IoU
  loss with the positive gather; the mined negatives are counted;
- ``ssd_predict``: the kept boxes, scores and labels equal within 1e-5 on
  seeded head outputs without ties;
- the two shipped SSD configs, narrowed by ``--cfg-options``, build through
  ``get_family`` and take one step on the CPU.

The JAX network and predictions are jitted once; the losses run eagerly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.losses import iou_loss as jiou
from sph_retina_tpu.models import ssd as jssd
from sph_retina_tpu.models import vgg as jvgg
from sph_retina_tpu_torch.losses import iou_loss as tiou
from sph_retina_tpu_torch.models import single_stage as tss
from sph_retina_tpu_torch.models import ssd as tssd
from sph_retina_tpu_torch.models import vgg as tvgg
from sph_retina_tpu_torch.models.from_flax import (
    from_flax,
    load_flax_variables,
    to_flax,
)
from sph_retina_tpu_torch.geometry import generate_boxes

from test_torch_model import randomize
from test_torch_fcos import one_cpu_step

CLASSES, H, W = 3, 64, 128
ATOL = 1e-4
PRIORS = (4, 6, 6, 6, 4, 4)


@pytest.fixture(scope="module")
def nets():
    flax_model = jssd.SphSSD(num_classes=CLASSES, dtype=jnp.float32)
    variables = jax.jit(flax_model.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, H, W, 3)))
    params = randomize(jax.device_get(variables["params"]), np.random
                       .default_rng(0))
    model = tssd.SphSSD(num_classes=CLASSES, dtype=torch.float32).eval()
    load_flax_variables(model, params)
    return flax_model, params, model


def test_from_flax_carries_every_leaf(nets):
    _, params, model = nets
    state = from_flax(params)
    assert set(state) == set(model.state_dict())
    assert tuple(state["backbone.l2_norm.weight"].shape) == (512,)
    back, stats = to_flax(state)
    assert stats == {}
    for path in (("backbone", "l2_norm", "scale"),
                 ("neck", "extra_3_conv", "kernel"),
                 ("bbox_head", "cls_conv_5", "bias")):
        a, b = back, params
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b)


def test_network_matches_flax(nets):
    flax_model, params, model = nets
    images = np.random.default_rng(1).normal(0, 1, (2, H, W, 3)).astype(
        np.float32)
    cls, reg = jax.jit(flax_model.apply)({"params": params},
                                         jnp.asarray(images))
    with torch.no_grad():
        t_cls, t_reg = model(torch.from_numpy(images))
    sizes = tssd.ssd_config(CLASSES, img_size=(H, W)).featmap_sizes()
    assert len(t_cls) == len(sizes) == 6
    for lvl, ((h, w), a) in enumerate(zip(sizes, PRIORS)):
        assert tuple(t_cls[lvl].shape) == (2, h * w * a, CLASSES + 1)
        assert tuple(t_reg[lvl].shape) == (2, h * w * a, 4)
        np.testing.assert_allclose(t_cls[lvl].numpy(), cls[lvl], atol=ATOL,
                                   rtol=1e-4)
        np.testing.assert_allclose(t_reg[lvl].numpy(), reg[lvl], atol=ATOL,
                                   rtol=1e-4)


def test_vgg_on_an_odd_sized_input(nets):
    """72x136: the pools see 36x68 -> 18x34 -> 9x17 -> 5x9 (ceil), so each
    ragged edge is padded; pool5 and the dilated conv6 keep 5x9."""
    _, params, model = nets
    x = np.random.default_rng(2).normal(0, 1, (1, 72, 136, 3)).astype(
        np.float32)
    want = jax.jit(jvgg.SSDVGG(dtype=jnp.float32).apply)(
        {"params": params["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[2:]) for g in got] == [(9, 17), (5, 9)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=ATOL, rtol=1e-4)


def test_anchors_match_the_jax_packages():
    for size in ((H, W), (72, 136)):
        tcfg = tssd.ssd_config(CLASSES, img_size=size)
        jcfg = jssd.ssd_config(CLASSES, img_size=size)
        gen = tcfg.anchor_generator()
        assert gen.num_base_anchors_per_level == list(PRIORS)
        np.testing.assert_allclose(tcfg.flat_anchors().numpy(),
                                   np.asarray(jcfg.flat_anchors()), atol=1e-5)
    assert tuple(tssd.ssd_config(37).flat_anchors().shape) == (49056, 4)


def _head_outputs(seed, b=2, d=4, scale=1.0):
    """Seeded head outputs of the 64x128 shapes: (cls, reg) per level."""
    rng = np.random.default_rng(seed)
    sizes = tssd.ssd_config(CLASSES, img_size=(H, W)).featmap_sizes()
    cls = [rng.normal(0, 2.0 * scale, (b, h * w * a, CLASSES + 1))
           .astype(np.float32) for (h, w), a in zip(sizes, PRIORS)]
    reg = [rng.normal(0, 0.5 * scale, (b, h * w * a, d)).astype(np.float32)
           for (h, w), a in zip(sizes, PRIORS)]
    return cls, reg


def _gts(seed, b=2, g=5):
    rng = np.random.default_rng(seed)
    boxes = np.stack([generate_boxes(g, 4, seed=seed + i,
                                     fov_range=(20.0, 70.0),
                                     phi_range=(30.0, 150.0))
                      for i in range(b)])
    labels = rng.integers(0, CLASSES, (b, g)).astype(np.int32)
    mask = np.arange(g)[None, :] < np.array([[4], [2]])
    return boxes, labels, mask


@pytest.mark.parametrize("decoded", [False, True],
                         ids=["smooth_l1_deltas", "decoded_sph2pob_iou"])
def test_ssd_loss_and_gradients_equal_the_jax_packages(decoded, monkeypatch):
    kw = dict(img_size=(H, W))
    if decoded:
        kw.update(reg_decoded_bbox=True, loss_pos_topk=64)
        jcfg = jssd.ssd_config(CLASSES, loss_bbox=functools.partial(
            jiou.sph2pob_iou_loss, mode="iou"), **kw)
        tcfg = tssd.ssd_config(CLASSES, loss_bbox=functools.partial(
            tiou.sph2pob_iou_loss, mode="iou"), **kw)
    else:
        jcfg, tcfg = jssd.ssd_config(CLASSES, **kw), tssd.ssd_config(CLASSES,
                                                                      **kw)
    cls, reg = _head_outputs(seed=3)
    boxes, labels, mask = _gts(seed=4)
    anchors = tcfg.flat_anchors()
    overlaps = tss._batch_pairwise_iou(torch.from_numpy(boxes), anchors,
                                       "sph2pob_efficient")
    monkeypatch.setattr(jssd, "_batch_pairwise_iou",
                        lambda gt, anc, backend: jnp.asarray(overlaps.numpy()))

    def jax_total(cls_, reg_):
        out = jssd.ssd_loss(jcfg, cls_, reg_, jcfg.flat_anchors(),
                            jnp.asarray(boxes), jnp.asarray(labels),
                            jnp.asarray(mask))
        return out["loss_cls"] + out["loss_bbox"], out

    (_, want), (g_cls, g_reg) = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg])

    t_cls = [torch.from_numpy(c).requires_grad_(True) for c in cls]
    t_reg = [torch.from_numpy(r).requires_grad_(True) for r in reg]
    got = tssd.ssd_loss(tcfg, t_cls, t_reg, anchors, torch.from_numpy(boxes),
                        torch.from_numpy(labels), torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=1e-5, err_msg=k)
    (got["loss_cls"] + got["loss_bbox"]).backward()
    for t, j in zip(t_cls + t_reg, list(g_cls) + list(g_reg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=1e-4)

    # the mined negatives: 3 x the image's positives (truncated), each
    # image's hardest, as many in both packages' gradients
    res = tcfg.assigner()(overlaps, torch.from_numpy(mask),
                          torch.from_numpy(labels))
    num_pos = (res.gt_inds > 0).sum(-1)
    num_neg = torch.minimum(3 * num_pos, (res.gt_inds == 0).sum(-1))
    assert int(num_pos.min()) > 0
    cls_all = torch.cat([t.grad for t in t_cls], 1)
    jcls_all = np.concatenate([np.asarray(j) for j in g_cls], 1)
    touched = (cls_all.abs().sum(-1) > 0).sum(-1)
    np.testing.assert_array_equal(touched.numpy(), (num_pos + num_neg).numpy())
    np.testing.assert_array_equal(
        touched.numpy(), (np.abs(jcls_all).sum(-1) > 0).sum(-1))
    if decoded:
        assert float(got["metric_pos_dropped"]) == 0.0


def test_ssd_predict_equals_the_jax_packages():
    cfg_kw = dict(img_size=(H, W), nms_pre=60, max_per_img=40)
    jcfg = jssd.ssd_config(CLASSES, **cfg_kw)
    tcfg = tssd.ssd_config(CLASSES, **cfg_kw)
    cls, reg = _head_outputs(seed=5, scale=1.0)
    want = jax.jit(lambda c, r: jssd.ssd_predict(jcfg, c, r))(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg])
    got = tssd.ssd_predict(tcfg, [torch.from_numpy(c) for c in cls],
                           [torch.from_numpy(r) for r in reg],
                           tcfg.level_anchors())
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    np.testing.assert_array_equal(gv, wv)
    assert 10 < gv.sum(1).min()
    np.testing.assert_array_equal(got.labels.numpy()[gv],
                                  np.asarray(want.labels)[wv])
    np.testing.assert_allclose(got.scores.numpy()[gv],
                               np.asarray(want.scores)[wv], atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy()[gv],
                               np.asarray(want.boxes)[wv], atol=1e-4)


@pytest.mark.parametrize("config", ["sph_ssd_vgg16_120e_indoor360.py",
                                    "sph_ssd_24e_spherebench.py"])
def test_shipped_config_builds_and_takes_one_cpu_step(config):
    model, det_cfg, metrics = one_cpu_step(config)
    assert isinstance(model, tssd.SphSSD)
    assert det_cfg.reg_decoded_bbox and det_cfg.loss_pos_topk == 512
    assert det_cfg.assign_backend == "sph2pob_efficient"
    assert det_cfg.nms_backend == "planar"
    assert set(metrics) == {"loss", "loss_cls", "loss_bbox",
                            "metric_pos_dropped"}

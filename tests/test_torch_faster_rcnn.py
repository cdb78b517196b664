"""The Faster R-CNN family of the PyTorch port vs the JAX package, on the CPU.

The JAX suite's fixture (B=2, 64x128, max_gt 6, 5 classes, 64 proposals,
32 rois, ``rpn_nms_pre`` 200) with an R18 backbone in fp32; the Flax
variables (seeded non-trivial biases and batch-norm parameters) are carried
across by ``from_flax``; the same numpy inputs go through both packages.
Both assigners compare floats exactly, so the JAX side is given the port's
overlaps (a ``pure_callback`` in place of its pairwise IoU), as in
``test_torch_assign_loss.py``. Tolerances:

- network outputs, RPN and RoI head: 1e-4 absolute + 1e-4 relative (fp32
  convolutions and products summed in another order);
- ``roi_align`` / ``multilevel_roi_align``: 1e-5 on features of order 1;
- proposals, sampled rois, predictions: masks and labels equal, boxes 1e-4
  degrees, scores 1e-5; the random sampler draws other priorities than
  ``jax.random``, so it is held to invariants, and to the JAX package only
  where its budget takes every candidate;
- losses 1e-4 (absolute + relative), their gradients with respect to the
  head outputs 1e-4, the heads' parameter gradients of the whole two-stage
  loss (OHEM, so that nothing random is drawn) 1e-4 + 1e-3 relative.

The JAX network is jitted once; its losses run eagerly.
"""

import functools
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.boxes import nms as jnms
from sph_retina_tpu.boxes import sampler as jsampler
from sph_retina_tpu.engine import zoo as jzoo
from sph_retina_tpu.losses import build_loss as jax_build_loss
from sph_retina_tpu.models import faster_rcnn as jfrcnn
from sph_retina_tpu.ops import fused_iou as jfused
from sph_retina_tpu_torch import apis as tapis
from sph_retina_tpu_torch import train as train_cli
from sph_retina_tpu_torch.boxes import nms as tnms
from sph_retina_tpu_torch.boxes import sampler as tsampler
from sph_retina_tpu_torch.engine import zoo as tzoo
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.losses import build_loss as torch_build_loss
from sph_retina_tpu_torch.models import faster_rcnn as tfrcnn
from sph_retina_tpu_torch.models.from_flax import (
    from_flax,
    load_flax_variables,
    to_flax,
)
from sph_retina_tpu_torch.models.single_stage import _batch_pairwise_iou
from sph_retina_tpu_torch.ops.sph2pob_iou import sph2pob_iou_pairwise

from test_torch_model import randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 64, 128
MAX_GT, NC = 6, 5
ATOL = 1e-4
SMALL = dict(img_size=(H, W), num_proposals=64, num_rois=32, rpn_nms_pre=200)


def _cfgs(**kw):
    kw = {**SMALL, **kw}
    jkw = dict(kw)
    if "loss_bbox" in kw:
        jkw["loss_bbox"] = jax_build_loss(kw["loss_bbox"])
        kw["loss_bbox"] = torch_build_loss(kw["loss_bbox"])
    return jfrcnn.faster_rcnn_config(NC, **jkw), \
        tfrcnn.faster_rcnn_config(NC, **kw)


def _gt(d=4):
    """The JAX suite's gts: 6 padded boxes a image, the first 4 valid."""
    boxes = np.stack([generate_boxes(MAX_GT, d, seed=i, fov_range=(50, 110))
                      for i in range(B)])
    labels = np.tile(np.arange(MAX_GT, dtype=np.int32) % NC, (B, 1))
    mask = np.tile(np.arange(MAX_GT) < 4, (B, 1))
    return boxes, labels, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.fixture
def port_overlaps(monkeypatch):
    """Both IoU sites of the JAX package's two-stage loss answered by the
    port (through a ``pure_callback``, so under tracing too): the RPN's
    anchors x gts and the RoI sampler's gts x candidates."""
    def rpn(gt, anchors, backend):
        def host(g, a):
            return _batch_pairwise_iou(*_t(g, a), backend).numpy()
        shape = (gt.shape[0], gt.shape[1], anchors.shape[0])
        return jax.pure_callback(host, jax.ShapeDtypeStruct(shape, jnp.float32),
                                 gt, anchors)

    def fused(b1, b2):
        gt = jnp.stack(b1, -1)[..., :, 0, :]      # (B, G, D)
        cand = jnp.stack(b2, -1)[..., 0, :, :]    # (B, K, D)

        def host(g, c):
            g, c = _t(g, c)
            return torch.stack([sph2pob_iou_pairwise(gi.contiguous(),
                                                     ci.contiguous())
                                for gi, ci in zip(g, c)]).numpy()
        shape = (gt.shape[0], gt.shape[1], cand.shape[1])
        return jax.pure_callback(host, jax.ShapeDtypeStruct(shape, jnp.float32),
                                 gt, cand)

    monkeypatch.setattr(jfrcnn, "_batch_pairwise_iou", rpn)
    monkeypatch.setattr(jfused, "fused_sph2pob_iou", fused)


@pytest.fixture(scope="module")
def nets():
    """(flax model, variables, port model, images, JAX network outputs)."""
    flax_model = jfrcnn.SphFasterRCNN(num_classes=NC, depth=18,
                                      dtype=jnp.float32)
    init = jax.jit(functools.partial(flax_model.init,
                                     method=jfrcnn.SphFasterRCNN.init_all))
    variables = init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    rng = np.random.default_rng(0)
    variables = {"params": randomize(jax.device_get(variables["params"]), rng),
                 "batch_stats": randomize(
                     jax.device_get(variables["batch_stats"]), rng)}
    model = tfrcnn.SphFasterRCNN(num_classes=NC, depth=18,
                                 dtype=torch.float32).eval()
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    images = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    (cls, reg), feats = jax.jit(flax_model.apply)(variables,
                                                  jnp.asarray(images))
    return flax_model, variables, model, images, (cls, reg, feats)


def test_from_flax_carries_the_dense_layers_both_ways(nets):
    _, variables, model, _, _ = nets
    state = from_flax(variables["params"], variables["batch_stats"])
    assert set(state) == set(model.state_dict())
    assert tuple(state["bbox_head.fc1.weight"].shape) == (1024, 7 * 7 * 256)
    assert tuple(state["bbox_head.fc_cls.weight"].shape) == (NC + 1, 1024)
    assert tuple(state["rpn_head.rpn_reg.weight"].shape) == (12, 256, 1, 1)
    back, back_stats = to_flax(state)
    for path in (("bbox_head", "fc1", "kernel"), ("bbox_head", "fc_reg", "bias"),
                 ("rpn_head", "rpn_cls", "kernel"),
                 ("neck", "extra_conv_0", "kernel")):
        a, b = back, variables["params"]
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        back_stats["backbone"]["layer4_1"]["bn2"]["mean"],
        variables["batch_stats"]["backbone"]["layer4_1"]["bn2"]["mean"])


def test_network_and_heads_match_flax(nets):
    flax_model, variables, model, images, (cls, reg, feats) = nets
    with torch.no_grad():
        (tcls, treg), tfeats = model(torch.from_numpy(images))
    cfg = tfrcnn.faster_rcnn_config(NC, img_size=(H, W))
    assert [tuple(f.shape[2:]) for f in tfeats] == cfg.featmap_sizes()
    for got, want in zip(tfeats, feats):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=ATOL, rtol=1e-4)
    for (h, w), g_cls, w_cls, g_reg, w_reg in zip(
            cfg.featmap_sizes(), tcls, cls, treg, reg):
        assert tuple(g_cls.shape) == (B, h * w * 3)
        assert tuple(g_reg.shape) == (B, h * w * 3, 4)
        np.testing.assert_allclose(g_cls.numpy(), w_cls, atol=ATOL, rtol=1e-4)
        np.testing.assert_allclose(g_reg.numpy(), w_reg, atol=ATOL, rtol=1e-4)

    roi_feats = np.random.default_rng(3).normal(0, 1, (5, 7, 7, 256)).astype(
        np.float32)
    want = flax_model.apply(variables, jnp.asarray(roi_feats),
                            method=jfrcnn.SphFasterRCNN.roi)
    with torch.no_grad():
        got = model.roi(torch.from_numpy(roi_feats))
    assert tuple(got[0].shape) == (5, NC + 1) and got[0].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=1e-4)


def _rois_xyxy(rng, n, size, big=False):
    h, w = size
    x1 = rng.uniform(-2, w * 0.8, n)
    y1 = rng.uniform(-2, h * 0.8, n)
    scale = 300.0 if big else 1.0
    return np.stack([x1, y1, x1 + rng.uniform(0.5, w, n) * scale,
                     y1 + rng.uniform(0.5, h, n) * scale], -1).astype(
        np.float32)


def test_roi_align_equals_the_jax_packages():
    rng = np.random.default_rng(5)
    feat = rng.normal(0, 1, (2, 16, 32, 8)).astype(np.float32)
    rois = np.stack([_rois_xyxy(rng, 9, (16, 32)) for _ in range(2)])
    for scale, sr in ((1.0, 2), (0.5, 1)):
        want = jax.jit(jax.vmap(functools.partial(
            jfrcnn.roi_align, out_size=7, spatial_scale=scale,
            sampling_ratio=sr)))(*_j(feat, rois))
        got = tfrcnn.roi_align(*_t(feat, rois), out_size=7,
                               spatial_scale=scale, sampling_ratio=sr)
        assert tuple(got.shape) == (2, 9, 7, 7, 8)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    tall = rng.normal(0, 1, (32, 16, 4)).astype(np.float32)  # H > W branch
    r = _rois_xyxy(rng, 5, (32, 16))
    np.testing.assert_allclose(
        tfrcnn.roi_align(*_t(tall, r)).numpy(),
        jax.jit(jfrcnn.roi_align)(*_j(tall, r)), atol=1e-5, rtol=0)


def test_multilevel_roi_align_equals_the_jax_packages():
    rng = np.random.default_rng(6)
    feats = [rng.normal(0, 1, (2 ** (5 - lv), 2 ** (6 - lv), 4)).astype(
        np.float32) for lv in range(4)]
    rois = np.concatenate([_rois_xyxy(rng, 6, (128, 256)),
                           _rois_xyxy(rng, 6, (128, 256), big=True)])
    want = jax.jit(jfrcnn.multilevel_roi_align)(_j(*feats), jnp.asarray(rois))
    got = tfrcnn.multilevel_roi_align(_t(*feats), torch.from_numpy(rois))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the rois spread over more than one level, and a batched call is the
    # per-image one
    sizes = np.sqrt((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]))
    assert len(set(np.clip(np.floor(np.log2(sizes / 56 + 1e-6)), 0, 3))) > 1
    batched = tfrcnn.multilevel_roi_align(
        [torch.from_numpy(f)[None].expand(2, *f.shape) for f in feats],
        torch.from_numpy(rois)[None].expand(2, *rois.shape))
    np.testing.assert_allclose(batched[1].numpy(), got.numpy(), atol=1e-6,
                               rtol=0)


def _rpn_outputs(seed, d=4):
    rng = np.random.default_rng(seed)
    sizes = tfrcnn.faster_rcnn_config(NC, img_size=(H, W)).featmap_sizes()
    cls = [rng.normal(0, 2.0, (B, h * w * 3)).astype(np.float32)
           for h, w in sizes]
    reg = [rng.normal(0, 0.3, (B, h * w * 3, d)).astype(np.float32)
           for h, w in sizes]
    return cls, reg


def test_rpn_proposals_equal_the_jax_packages():
    jcfg, tcfg = _cfgs()
    cls, reg = _rpn_outputs(seed=7)
    want = jax.jit(lambda c, r: jfrcnn.rpn_proposals(jcfg, c, r))(
        list(_j(*cls)), list(_j(*reg)))
    got = tfrcnn.rpn_proposals(tcfg, list(_t(*cls)), list(_t(*reg)))
    gv, wv = got[2].numpy(), np.asarray(want[2])
    np.testing.assert_array_equal(gv, wv)
    assert tuple(got[0].shape) == (B, 64, 4)
    assert 10 < gv.sum(1).min()
    np.testing.assert_allclose(got[1].numpy()[gv], np.asarray(want[1])[wv],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0].numpy()[gv], np.asarray(want[0])[wv],
                               atol=ATOL, rtol=0)


def test_rpn_loss_and_gradients_equal_the_jax_packages(port_overlaps):
    jcfg, tcfg = _cfgs()
    cls, reg = _rpn_outputs(seed=8)
    boxes, _, mask = _gt()
    def jax_total(c, r):
        out = jfrcnn.rpn_loss(jcfg, c, r, *_j(boxes, mask))
        return sum(out.values()), out

    (_, parts), grads = jax.jit(jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True))(
        list(_j(*cls)), list(_j(*reg)))
    tc = [t.requires_grad_(True) for t in _t(*cls)]
    tr = [t.requires_grad_(True) for t in _t(*reg)]
    got = tfrcnn.rpn_loss(tcfg, tc, tr, *_t(boxes, mask))
    assert set(got) == set(parts) == {"loss_rpn_cls", "loss_rpn_bbox"}
    for k in parts:
        np.testing.assert_allclose(float(got[k]), float(parts[k]), atol=ATOL,
                                   rtol=1e-5, err_msg=k)
    assert float(got["loss_rpn_bbox"]) > 0
    sum(got.values()).backward()
    for t_list, j_list in zip((tc, tr), grads):
        for t, j in zip(t_list, j_list):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                       atol=ATOL, rtol=1e-4)


def _proposals(seed, p=64):
    """Proposals around the gts (so that some are positive) and elsewhere,
    a random share of them invalid."""
    rng = np.random.default_rng(seed)
    boxes, labels, mask = _gt()
    props = np.stack([generate_boxes(p, 4, seed=seed + i, fov_range=(20, 90))
                      for i in range(B)])
    jitter = rng.normal(0, 4.0, (B, MAX_GT * 4, 4)).astype(np.float32)
    props[:, :MAX_GT * 4] = np.tile(boxes, (1, 4, 1)) + jitter
    valid = rng.uniform(size=(B, p)) < 0.8
    return props.astype(np.float32), valid, boxes, labels, mask


def test_sample_rois_with_ohem_equals_the_jax_packages(port_overlaps):
    jcfg, tcfg = _cfgs()
    props, valid, boxes, labels, mask = _proposals(seed=11)
    k = props.shape[1] + MAX_GT
    hard = np.random.default_rng(12).uniform(size=(B, k)).astype(np.float32)
    want = jax.jit(lambda *a: jfrcnn.sample_rois(
        jcfg, jax.random.PRNGKey(0), *a,
        hardness_fn=lambda c, lab: jnp.asarray(hard)))(
        *_j(props, valid, boxes, labels, mask))
    got = tfrcnn.sample_rois(tcfg, None,
                             *_t(props, valid, boxes, labels, mask),
                             hardness_fn=lambda c, lab: torch.from_numpy(hard))
    assert got.labels.dtype == torch.int32 and got.pos_mask.dtype == torch.bool
    for name in ("labels", "weights", "pos_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for name in ("rois", "reg_targets"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=0, err_msg=name)
    pos = got.pos_mask.numpy()
    assert 0 < pos.sum(1).min() and pos.sum(1).max() <= 8
    assert (got.weights.numpy() == 1).sum(1).min() > pos.sum(1).max()


def test_random_sampling_keeps_its_invariants_and_its_budget(port_overlaps):
    _, tcfg = _cfgs()
    props, valid, boxes, labels, mask = _proposals(seed=13)
    args = _t(props, valid, boxes, labels, mask)
    a = tfrcnn.sample_rois(tcfg, torch.Generator().manual_seed(0), *args)
    b = tfrcnn.sample_rois(tcfg, torch.Generator().manual_seed(1), *args)
    assert not torch.equal(a.rois, b.rois)  # the generator decides
    cand_valid = np.concatenate([valid, mask], 1)
    cand = np.concatenate([props, boxes], 1)
    for t in (a, b):
        pos, w = t.pos_mask.numpy(), t.weights.numpy()
        assert pos.sum(1).max() <= int(32 * 0.25)
        assert (pos <= (w == 1)).all()
        assert (t.labels.numpy()[pos] < NC).all()
        assert (t.labels.numpy()[~pos] == NC).all()
        # every kept roi is a valid candidate; the valid gts are candidates,
        # so every image has positives
        for i in range(B):
            kept = t.rois.numpy()[i][w[i] == 1]
            ok = cand[i][cand_valid[i]]
            assert all(np.abs(ok - r).max(1).min() == 0 for r in kept)
            assert pos[i].sum() > 0

    # a budget larger than every group: both packages keep every valid
    # candidate, in another order
    jcfg, tcfg = _cfgs(num_rois=2 * (props.shape[1] + MAX_GT),
                       pos_fraction=0.5)
    want = jax.jit(lambda *a: jfrcnn.sample_rois(
        jcfg, jax.random.PRNGKey(3), *a))(
        *_j(props, valid, boxes, labels, mask))
    got = tfrcnn.sample_rois(tcfg, torch.Generator().manual_seed(3), *args)

    def kept_rows(t):
        w = np.asarray(t.weights) == 1
        rows = np.concatenate([np.asarray(t.rois),
                               np.asarray(t.labels)[..., None],
                               np.asarray(t.reg_targets)], -1)
        return [np.round(r[m], 4)[np.lexsort(np.round(r[m], 4).T[::-1])]
                for r, m in zip(rows, w)]

    for g, w in zip(kept_rows(got), kept_rows(want)):
        assert len(g) == len(w) > 20
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=0)


def test_random_sampler_equals_the_jax_packages_where_the_budget_allows():
    gt_inds = np.random.default_rng(2).integers(-1, 4, (3, 40)).astype(
        np.int32)
    for num, frac in ((256, 0.5), (12, 0.25)):
        jres = jsampler.RandomSampler(num=num, pos_fraction=frac)(
            jax.random.PRNGKey(0), jnp.asarray(gt_inds[0]))
        tres = tsampler.RandomSampler(num=num, pos_fraction=frac)(
            torch.Generator().manual_seed(0), torch.from_numpy(gt_inds))
        pos, neg = tres.pos_mask.numpy(), tres.neg_mask.numpy()
        assert (pos <= (gt_inds > 0)).all() and (neg <= (gt_inds == 0)).all()
        assert pos.sum(1).max() <= int(num * frac)
        assert neg.sum(1).max() <= num - int(num * frac)
        if num == 256:  # every entry fits the budget
            np.testing.assert_array_equal(pos[0], np.asarray(jres.pos_mask))
            np.testing.assert_array_equal(neg[0], np.asarray(jres.neg_mask))
        else:
            assert pos.sum(1).min() > 0
    ps = tsampler.pseudo_sample(torch.from_numpy(gt_inds))
    np.testing.assert_array_equal(ps.pos_mask.numpy(), gt_inds > 0)
    np.testing.assert_array_equal(ps.neg_mask.numpy(), gt_inds == 0)


def _roi_targets(seed, d):
    rng = np.random.default_rng(seed)
    r = 32
    rois = np.stack([generate_boxes(r, d, seed=seed + i, fov_range=(10, 60))
                     for i in range(B)])
    pos = rng.uniform(size=(B, r)) < 0.3
    weights = (pos | (rng.uniform(size=(B, r)) < 0.7)).astype(np.float32)
    labels = np.where(pos, rng.integers(0, NC, (B, r)), NC).astype(np.int32)
    reg_t = rng.normal(0, 0.5, (B, r, d)).astype(np.float32)
    return (rois, labels, reg_t, weights, pos)


@pytest.mark.parametrize("d, loss", [
    (4, None), (4, {"type": "SphL1Loss"}), (5, {"type": "SphL1Loss"})],
    ids=["l1_deltas", "decoded", "decoded_5dof"])
def test_rcnn_loss_and_gradients_equal_the_jax_packages(d, loss):
    """Both branches. The decoded one decodes both sides against the rois
    and hands the loss a (K, D) weight; it is held here with the L1 loss on
    decoded boxes, since the eager JAX Sph2Pob IoU loss and its gradient
    cost ~18 s to dispatch on the CPU, and that loss is held to the JAX
    package, gradients included, in ``test_torch_iou_losses.py``."""
    kw = {} if loss is None else dict(loss_bbox=loss, reg_decoded_bbox=True)
    jcfg, tcfg = _cfgs(box_version=d, **kw)
    targets = _roi_targets(seed=20 + d, d=d)
    rng = np.random.default_rng(21)
    logits = rng.normal(0, 1, (B * 32, NC + 1)).astype(np.float32)
    reg = (targets[2].reshape(-1, d)
           + rng.normal(0, 0.2, (B * 32, d))).astype(np.float32)

    def jax_total(lg, rg):
        out = jfrcnn.rcnn_loss(jcfg, lg, rg, jfrcnn.RoITargets(*_j(*targets)))
        return sum(out.values()), out

    (_, want), grads = jax.value_and_grad(jax_total, argnums=(0, 1),
                                          has_aux=True)(*_j(logits, reg))
    tl, tr = (t.requires_grad_(True) for t in _t(logits, reg))
    got = tfrcnn.rcnn_loss(tcfg, tl, tr, tfrcnn.RoITargets(*_t(*targets)))
    assert set(got) == set(want) == {"loss_cls", "loss_bbox"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=1e-5, err_msg=k)
    assert float(got["loss_bbox"]) > 0
    sum(got.values()).backward()
    for t, j in zip((tl, tr), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=1e-4)


@pytest.mark.parametrize("nms", [
    {}, {"nms_type": "soft_nms", "soft_method": "linear"},
    {"nms_type": "soft_nms", "soft_method": "gaussian", "soft_sigma": 0.5}],
    ids=["nms", "soft_linear", "soft_gaussian"])
def test_rcnn_predict_equals_the_jax_packages(nms):
    jcfg, tcfg = _cfgs(max_per_img=30, **nms)
    rng = np.random.default_rng(30)
    p = 64
    logits = rng.normal(0, 2.0, (B, p, NC + 1)).astype(np.float32)
    reg = rng.normal(0, 0.3, (B, p, 4)).astype(np.float32)
    rois = np.stack([generate_boxes(p // 4, 4, seed=31 + i,
                                    fov_range=(20, 60)) for i in range(B)])
    rois = np.repeat(rois, 4, axis=1) + rng.normal(0, 3.0, (B, p, 4)).astype(
        np.float32)  # clusters of four: boxes overlap
    valid = rng.uniform(size=(B, p)) < 0.9
    want = jax.jit(lambda *a: jfrcnn.rcnn_predict(jcfg, *a))(
        *_j(logits, reg, rois, valid))
    got = tfrcnn.rcnn_predict(tcfg, *_t(logits, reg, rois, valid))
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum(1).min() >= 10
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy()[gv],
                               np.asarray(want.boxes)[wv], atol=ATOL, rtol=0)


def _nms_inputs(seed, d, n=60):
    rng = np.random.default_rng(seed)
    centres = generate_boxes(n // 3, d, seed=seed, fov_range=(20, 50))
    boxes = np.repeat(centres, 3, axis=0)
    boxes[:, :2] += rng.normal(0, 4.0, (n, 2))
    scores = rng.uniform(0.05, 1.0, n).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.uniform(size=n) < 0.9
    return boxes.astype(np.float32), scores, labels, valid


@pytest.mark.parametrize("d, method", [(4, "linear"), (4, "gaussian"),
                                       (5, "linear")])
def test_soft_nms_equals_the_jax_packages(d, method):
    boxes, scores, labels, valid = _nms_inputs(40 + d, d)
    kw = dict(iou_threshold=0.3, sigma=0.5, min_score=0.05, method=method,
              max_num=40, nms_pre=50, backend="planar")
    want = jnms.sph_batched_soft_nms(*_j(boxes, scores, labels),
                                     valid_mask=jnp.asarray(valid), **kw)
    got = tnms.sph_batched_soft_nms(*_t(boxes, scores, labels),
                                    valid_mask=torch.from_numpy(valid), **kw)
    for name in ("valid", "labels", "inds"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-6, rtol=0)
    # scores decay instead of being removed: more valid picks than hard NMS
    hard = tnms.planar_batched_nms(*_t(boxes, scores, labels),
                                   valid_mask=torch.from_numpy(valid),
                                   iou_threshold=0.3, max_num=40, nms_pre=50)
    assert int(got.valid.sum()) > int(hard.valid.sum())
    kept = got.scores.numpy()[got.valid.numpy()]
    assert (kept < scores[got.inds.numpy()[got.valid.numpy()]] - 1e-6).any()


@pytest.mark.parametrize("d", [4, 5])
def test_planar_batched_nms_equals_the_jax_packages(d):
    boxes, scores, labels, valid = _nms_inputs(50 + d, d)
    kw = dict(iou_threshold=0.4, max_num=30, nms_pre=50)
    want = jnms.planar_batched_nms(*_j(boxes, scores, labels),
                                   valid_mask=jnp.asarray(valid), **kw)
    got = tnms.planar_batched_nms(*_t(boxes, scores, labels),
                                  valid_mask=torch.from_numpy(valid), **kw)
    for name in ("valid", "labels", "inds"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert 5 < int(got.valid.sum()) < int(valid.sum())
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=0, rtol=0)


def test_family_loss_and_head_gradients_equal_the_jax_packages(
        nets, port_overlaps):
    """``FasterRCNNFamily.loss_fn`` of both packages on the OHEM config (the
    hardness is a head forward, so nothing random is drawn): the four losses
    and the gradients of every leaf of the RPN and the RoI head."""
    flax_model, variables, model, images, _ = nets
    jcfg, tcfg = _cfgs(sampler_type="ohem")
    boxes, labels, mask = _gt()
    jbatch = dict(zip(("images", "gt_boxes", "gt_labels", "gt_mask"),
                      _j(images, boxes, labels, mask)))
    tbatch = dict(zip(jbatch, _t(images, boxes, labels, mask)))
    jloss = jzoo.FasterRCNNFamily.loss_fn(flax_model, jcfg)
    params = variables["params"]
    heads = {k: params[k] for k in ("rpn_head", "bbox_head")}
    # jitted (eagerly, every operation of the network would compile on its
    # own), and differentiated with respect to the heads only
    (_, want), grads = jax.jit(jax.value_and_grad(
        lambda h: jloss(dict(variables, params={**params, **h}), jbatch,
                        jax.random.PRNGKey(0)), has_aux=True))(heads)
    model.zero_grad()
    total, got = tzoo.FasterRCNNFamily.loss_fn(model, tcfg)(tbatch, None)
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_bbox",
                                     "loss_cls", "loss_bbox"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=1e-4, err_msg=k)
    total.backward()
    tgrads, _ = to_flax({n: p.grad for n, p in model.named_parameters()
                         if n.startswith(("rpn_head", "bbox_head"))})
    for head in ("rpn_head", "bbox_head"):
        for layer, leaves in tgrads[head].items():
            for leaf, g in leaves.items():
                want_g = np.asarray(grads[head][layer][leaf])
                assert np.abs(want_g).max() > 0, (head, layer, leaf)
                np.testing.assert_allclose(
                    g, want_g, atol=ATOL, rtol=1e-3,
                    err_msg=f"{head}/{layer}/{leaf}")
    model.zero_grad()


def _small_cli(config, extra=()):
    return [os.path.join(REPO, "configs", config), "--synthetic",
            "--max-epochs", "1", "--cfg-options", "img_size=(64,128)",
            "bf16=False", "data.samples_per_gpu=2", "data.n_synthetic=2",
            "data.max_gt=6", "log_config.interval=1", *extra]


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
def test_the_trainer_takes_a_step_of_the_sphere_bench_config_on_the_cpu(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = _small_cli("sph_faster_rcnn_r18_fpn_24e_spherebench.py")
    assert train_cli.main(argv + ["--device", "cpu", "--work-dir",
                                  str(tmp_path)]) == 0
    assert "training done" in capsys.readouterr().out
    with open(tmp_path / "metrics.jsonl") as f:
        train = [r for r in map(json.loads, f) if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [1]
    keys = ("loss", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")
    assert all(np.isfinite(train[0][k]) for k in keys)
    if not torch.cuda.is_available():  # no device argument: the card, or raise
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cli.main(argv + ["--work-dir", str(tmp_path / "b")])


def test_the_soft_nms_config_serves_decayed_scores_on_the_cpu():
    det = tapis.init_detector(
        os.path.join(REPO, "configs",
                     "sph_faster_rcnn_r50_fpn_soft_nms_120e_indoor360.py"),
        cfg_options=["img_size=(64,128)", "bf16=False",
                     "model.backbone.depth=18", "test_cfg.score_thr=0.0"],
        device="cpu")
    cfg = det.det_cfg
    assert (cfg.nms_type, cfg.soft_method, cfg.nms_iou_thr,
            cfg.soft_min_score, cfg.sampler_type) == (
        "soft_nms", "linear", 0.5, 1e-3, "random")
    with torch.no_grad():
        det.model.bbox_head.fc_cls.weight.mul_(30.0)  # spread the scores
    image = np.random.default_rng(0).integers(0, 256, (64, 128, 3),
                                              dtype=np.uint8)
    result = tapis.inference_detector(det, image)
    assert len(result) == 37
    rows = np.concatenate(result)
    assert rows.shape[1] == 5 and len(rows) == 100
    assert np.isfinite(rows).all() and (rows[:, -1] >= 1e-3).all()

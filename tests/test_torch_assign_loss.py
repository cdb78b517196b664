"""Assignment and losses of the PyTorch port vs the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``sph_retina_tpu_torch``. Tolerances:

- ``MaxIoUAssigner``: ``gt_inds`` and ``labels`` equal (integers decided by
  comparisons on the same float32 overlaps), ``max_overlaps`` equal;
- focal, L1, smooth-L1, cross-entropy and ``weight_reduce_loss``: 1e-6 on the
  value and on the gradient (closed forms in fp32; what remains is each
  library's exp/log1p and the order of one sum);
- ``anchor_targets``: labels and weights equal, targets 1e-5, **on the same
  overlaps**. Low-quality matching compares floats exactly (``overlaps ==
  gt_max``), and neighbouring anchors often tie at a gt's best overlap to the
  last bit: two IoU implementations that agree to 1e-7 then disagree on which
  of them are candidates (24 of 3078 labels on this seed). So the JAX side's
  IoU call is replaced, in the test only, by a callback into the port's, and
  the overlaps themselves are held to the JAX package's at 1e-4 here and in
  ``test_torch_fused_iou.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.boxes.assigner import MaxIoUAssigner as JaxAssigner
from sph_retina_tpu.geometry import generate_boxes
from sph_retina_tpu.losses import focal_loss as jfocal
from sph_retina_tpu.losses import l1_loss as jl1
from sph_retina_tpu.losses import utils as jutils
from sph_retina_tpu.models import single_stage as jss
from sph_retina_tpu.ops import sph2pob_iou_pairwise_tpu
from sph_retina_tpu_torch import losses as tlosses
from sph_retina_tpu_torch.boxes.assigner import MaxIoUAssigner
from sph_retina_tpu_torch.losses import focal_loss as tfocal
from sph_retina_tpu_torch.losses import l1_loss as tl1
from sph_retina_tpu_torch.losses import utils as tutils
from sph_retina_tpu_torch.models import single_stage as tss

G, N = 6, 48


def _overlaps(seed, zero_row=None):
    """Overlaps on a 0.05 grid, so that ties are common, row-wise and
    column-wise."""
    rng = np.random.default_rng(seed)
    ov = (rng.integers(0, 21, (G, N)) * 0.05).astype(np.float32)
    if zero_row is not None:
        ov[zero_row] = 0.0
    return ov


ASSIGN_CASES = {
    "ties": (dict(), _overlaps(0), [1, 1, 1, 1, 0, 0]),
    "all_padded": (dict(), _overlaps(1), [0] * G),
    "all_valid": (dict(), _overlaps(2), [1] * G),
    # a valid gt whose best overlap is 0 claims every anchor it has overlap
    # 0 with (min_pos_iou=0.0): mmdet's behaviour, kept by both packages
    "gt_with_best_overlap_zero": (dict(), _overlaps(3, zero_row=2), [1] * G),
    "min_pos_iou": (dict(min_pos_iou=0.3), _overlaps(3, zero_row=2), [1] * G),
    "tuple_neg_thr": (dict(neg_iou_thr=(0.1, 0.4)), _overlaps(4),
                      [1, 1, 1, 0, 1, 1]),
    "single_best_anchor": (dict(gt_max_assign_all=False), _overlaps(5),
                           [1, 1, 1, 1, 1, 0]),
    "no_low_quality": (dict(match_low_quality=False), _overlaps(6),
                       [1, 0, 1, 1, 1, 1]),
    "high_thresholds": (dict(pos_iou_thr=0.7, neg_iou_thr=0.3), _overlaps(7),
                        [1, 1, 0, 1, 1, 1]),
}


@pytest.mark.parametrize("case", sorted(ASSIGN_CASES))
@pytest.mark.parametrize("with_labels", [True, False])
def test_assigner_equals_the_jax_packages(case, with_labels):
    kwargs, ov, mask = ASSIGN_CASES[case]
    mask = np.asarray(mask, bool)
    labels = (np.arange(G) * 3 % 7).astype(np.int32) if with_labels else None
    want = JaxAssigner(**kwargs)(
        jnp.asarray(ov), jnp.asarray(mask),
        None if labels is None else jnp.asarray(labels))
    got = MaxIoUAssigner(**kwargs)(
        torch.from_numpy(ov), torch.from_numpy(mask),
        None if labels is None else torch.from_numpy(labels))
    assert got.gt_inds.dtype == torch.int32 and got.labels.dtype == torch.int32
    np.testing.assert_array_equal(got.gt_inds.numpy(), np.asarray(want.gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.max_overlaps.numpy(),
                                  np.asarray(want.max_overlaps))
    if case == "gt_with_best_overlap_zero":
        zero_cols = ov[2] == 0.0  # the whole row: every anchor is a candidate
        later = np.asarray(want.gt_inds) > 3
        assert zero_cols.all() and ((np.asarray(want.gt_inds) == 3) | later).all()


def test_assigner_on_a_batch_equals_image_by_image():
    cases = [ASSIGN_CASES[k] for k in ("ties", "all_padded", "all_valid")]
    ov = torch.from_numpy(np.stack([c[1] for c in cases]))
    mask = torch.from_numpy(np.asarray([c[2] for c in cases], bool))
    labels = torch.from_numpy(
        np.tile((np.arange(G) % 7).astype(np.int32), (3, 1)))
    assigner = MaxIoUAssigner()
    batched = assigner(ov, mask, labels)
    for i in range(3):
        one = assigner(ov[i], mask[i], labels[i])
        for a, b in zip(batched, one):
            np.testing.assert_array_equal(a[i].numpy(), b.numpy())


# --------------------------------------------------------------------------- #
# losses: value and gradient
# --------------------------------------------------------------------------- #
def _both(jax_fn, torch_fn, x, *rest, **kwargs):
    """Value and gradient w.r.t. ``x`` of a scalar loss, through both."""
    jrest = [None if r is None else jnp.asarray(r) for r in rest]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kwargs.items()}
    jval, jgrad = jax.value_and_grad(
        lambda a: jax_fn(a, *jrest, **jkw))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    trest = [None if r is None else torch.from_numpy(r) for r in rest]
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kwargs.items()}
    tval = torch_fn(tx, *trest, **tkw)
    (tgrad,) = torch.autograd.grad(tval, tx)
    return (float(jval), np.asarray(jgrad)), (float(tval), tgrad.numpy())


def _assert_close(jax_side, torch_side):
    np.testing.assert_allclose(torch_side[0], jax_side[0], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(torch_side[1], jax_side[1], atol=1e-6, rtol=0)


FOCAL_CASES = {
    "defaults_avg_factor": dict(avg_factor=np.float32(5.0)),
    "no_avg_factor": dict(),
    "sum": dict(reduction="sum"),
    "gamma_alpha": dict(gamma=1.5, alpha=0.4, avg_factor=np.float32(3.0),
                        loss_weight=2.0),
}


@pytest.mark.parametrize("case", sorted(FOCAL_CASES))
def test_focal_loss_value_and_gradient(case):
    rng = np.random.default_rng(0)
    c = 7
    logits = rng.normal(0.0, 2.0, (60, c)).astype(np.float32)
    labels = rng.integers(0, c + 1, 60).astype(np.int32)  # c = background
    labels[:4] = c
    weight = (rng.random(60) > 0.2).astype(np.float32)
    kwargs = dict(FOCAL_CASES[case])
    avg = kwargs.pop("avg_factor", None)
    if avg is not None:
        kwargs["avg_factor"] = np.asarray(avg)
    j, t = _both(jfocal.sigmoid_focal_loss, tfocal.sigmoid_focal_loss,
                 logits, labels, weight, **kwargs)
    _assert_close(j, t)
    assert t[0] > 0


def test_focal_loss_background_rows_have_an_all_zero_target():
    logits = torch.zeros((3, 4))
    labels = torch.tensor([4, 4, 4], dtype=torch.int32)
    got = tfocal.sigmoid_focal_loss(logits, labels, reduction="none")
    # p = 0.5 everywhere, target 0: (1 - alpha) * 0.25 * log 2
    np.testing.assert_allclose(got.numpy(), 0.75 * 0.25 * np.log(2.0),
                               rtol=1e-6)


def test_cross_entropy_value_and_gradient():
    rng = np.random.default_rng(1)
    logits = rng.normal(0.0, 2.0, (40, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 40).astype(np.int32)
    weight = rng.random(40).astype(np.float32)
    _assert_close(*_both(jfocal.cross_entropy_loss, tfocal.cross_entropy_loss,
                         logits, labels, weight))


@pytest.mark.parametrize("name, kwargs", [
    ("sph_l1_loss", dict(avg_factor=np.float32(7.0))),
    ("sph_l1_loss", dict()),
    ("sph_l1_loss", dict(reduction="sum", loss_weight=0.5)),
    ("smooth_l1_loss", dict(avg_factor=np.float32(7.0))),
    ("smooth_l1_loss", dict(beta=0.3)),
], ids=["l1_avg", "l1_mean", "l1_sum", "smooth_avg", "smooth_beta"])
def test_l1_family_value_and_gradient(name, kwargs):
    rng = np.random.default_rng(2)
    pred = rng.normal(0.0, 1.0, (50, 5)).astype(np.float32)
    target = rng.normal(0.0, 1.0, (50, 5)).astype(np.float32)
    weight = np.repeat((rng.random(50) > 0.5).astype(np.float32)[:, None], 5, 1)
    kwargs = {k: (np.asarray(v) if isinstance(v, np.floating) else v)
              for k, v in kwargs.items()}
    _assert_close(*_both(getattr(jl1, name), getattr(tl1, name),
                         pred, target, weight, **kwargs))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("avg_factor", [None, 3.0, "array"])
def test_weight_reduce_loss(reduction, weighted, avg_factor):
    rng = np.random.default_rng(3)
    loss = rng.random((20, 4)).astype(np.float32)
    weight = rng.random((20, 4)).astype(np.float32) if weighted else None
    javg = tavg = avg_factor
    if avg_factor == "array":
        javg, tavg = jnp.float32(0.0), torch.tensor(0.0)  # clamps to 1e-6
    want = jutils.weight_reduce_loss(
        jnp.asarray(loss), None if weight is None else jnp.asarray(weight),
        reduction, javg)
    got = tutils.weight_reduce_loss(
        torch.from_numpy(loss),
        None if weight is None else torch.from_numpy(weight), reduction, tavg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError, match="reduction"):
        tutils.weight_reduce_loss(torch.from_numpy(loss), None, "median")


def test_reduce_box_weight_and_build_loss():
    w = np.random.default_rng(4).random((9, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tutils.reduce_box_weight(torch.from_numpy(w)).numpy(),
        np.asarray(jutils.reduce_box_weight(jnp.asarray(w))), rtol=1e-6)
    assert tutils.reduce_box_weight(None) is None
    fn = tlosses.build_loss({"type": "SmoothL1Loss", "beta": 0.5,
                             "loss_weight": 2.0})
    a, b = torch.zeros((3, 4)), torch.full((3, 4), 0.25)
    np.testing.assert_allclose(float(fn(a, b)), 2.0 * 0.5 * 0.0625 / 0.5)
    assert tlosses.build_loss({"type": "L1Loss"}).func is tl1.sph_l1_loss
    assert tlosses.build_loss({"type": "FocalLoss", "use_sigmoid": True}
                              ).func is tfocal.sigmoid_focal_loss
    assert tlosses.build_loss({"type": "Sph2PobKLDLoss", "loss_weight": 1.0}
                              ).func is tlosses.sph2pob_kld_loss
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.build_loss({"type": "NoSuchLoss"})


# --------------------------------------------------------------------------- #
# anchor targets on a seeded batch
# --------------------------------------------------------------------------- #
def port_iou_callback(anchors: torch.Tensor):
    """A stand-in for the JAX package's ``_batch_pairwise_iou`` that asks the
    port for the overlaps, so that both assigners see the same floats."""

    def host(gt):
        return tss._batch_pairwise_iou(
            torch.from_numpy(np.asarray(gt)), anchors,
            "sph2pob_efficient").numpy()

    def call(gt, jax_anchors, backend):
        shape = jax.ShapeDtypeStruct(
            (gt.shape[0], gt.shape[1], jax_anchors.shape[0]), jnp.float32)
        return jax.pure_callback(host, shape, gt)

    return call


@pytest.mark.parametrize("version, decoded", [(4, False), (5, False),
                                              (5, True)])
def test_anchor_targets_equal_the_jax_packages(version, decoded, monkeypatch):
    b, max_gt, classes = 2, 8, 7
    jcfg = jss.retina_config(classes, box_version=version, img_size=(64, 128),
                             reg_decoded_bbox=decoded)
    tcfg = tss.retina_config(classes, box_version=version, img_size=(64, 128),
                             reg_decoded_bbox=decoded)
    boxes = np.stack([generate_boxes(max_gt, version, seed=10 + i,
                                     fov_range=(10.0, 60.0))
                      for i in range(b)])
    labels = np.tile(np.arange(max_gt, dtype=np.int32) % classes, (b, 1))
    mask = np.stack([np.arange(max_gt) < 5, np.arange(max_gt) < 0])
    mask[1, :2] = True

    anchors = tcfg.flat_anchors()
    np.testing.assert_allclose(anchors.numpy(),
                               np.asarray(jcfg.flat_anchors()), atol=1e-5)
    ov = tss._batch_pairwise_iou(torch.from_numpy(boxes), anchors,
                                 tcfg.assign_backend)
    # what the JAX package's _batch_pairwise_iou calls on the TPU, run as
    # its own tests run it on the CPU (interpret mode)
    jov = sph2pob_iou_pairwise_tpu(
        jnp.asarray(boxes.reshape(-1, version)), jcfg.flat_anchors(), tile_n=16)
    np.testing.assert_allclose(ov.reshape(b * max_gt, -1).numpy(),
                               np.asarray(jov), atol=1e-4, rtol=0)

    monkeypatch.setattr(jss, "_batch_pairwise_iou", port_iou_callback(anchors))
    want = jss.anchor_targets(jcfg, jcfg.flat_anchors(), jnp.asarray(boxes),
                              jnp.asarray(labels), jnp.asarray(mask))
    got = tss.anchor_targets(tcfg, anchors, torch.from_numpy(boxes),
                             torch.from_numpy(labels), torch.from_numpy(mask))

    assert got.labels.dtype == torch.int32
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.label_weights.numpy(),
                                  np.asarray(want.label_weights))
    np.testing.assert_array_equal(got.bbox_weights.numpy(),
                                  np.asarray(want.bbox_weights))
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), atol=1e-5, rtol=0)
    assert int(got.num_pos) == int(want.num_pos) > 0
    assert got.bbox_targets.shape == (b, anchors.shape[0], version)
    assert not got.bbox_targets.requires_grad


def test_assign_backends_that_wait_raise_by_name():
    # no backend waits any more: kent assigns (held to the JAX package in
    # tests/test_torch_kent.py), and a name the package lacks raises by name
    gt = torch.tensor([[[60.0, 90.0, 40.0, 30.0], [200.0, 80.0, 50.0, 50.0]]])
    args = (gt, torch.zeros((1, 2), dtype=torch.int32),
            torch.ones((1, 2), dtype=torch.bool))
    cfg = tss.retina_config(7, img_size=(64, 128), assign_backend="kent_iou")
    got = tss.anchor_targets(cfg, cfg.flat_anchors(), *args)
    assert int(got.num_pos) >= 2
    cfg = tss.retina_config(7, img_size=(64, 128), assign_backend="nonsense")
    with pytest.raises(ValueError, match="nonsense"):
        tss.anchor_targets(cfg, cfg.flat_anchors(), *args)

"""The Kent subsystem of the PyTorch port vs the JAX package, on the CPU.

The same seeded boxes go through ``sph_retina_tpu.iou.kent`` and
``sph_retina_tpu_torch.iou.kent``. Tolerances:

- kappa: relative, ``KAPPA_RTOL``; beta: ``KAPPA_RTOL`` times kappa. kappa
  reaches 1e4 for narrow boxes, where it is 1 / (2 - 2 r1 - r2) of a small
  difference of 121-point means that the two libraries sum in another
  order, and beta's error follows kappa's (measured: 6.5e-4 of kappa);
- the frame angles: 1e-4 absolute (``ATOL``), alpha as it is, eta modulo
  2 pi and psi modulo pi (an axis has two directions), and psi only where
  beta > 0.05 kappa: for a (near-)isotropic box the major axis is
  arbitrary (beta ~ 0 makes it irrelevant), and rounding picks it;
- psi of narrow boxes (FoV of a few degrees) is fp32 noise in both
  packages: the 2x2 moments are ~1e-4 differences of 3x3 moments of order
  1, so psi moves by ~1e-3 rad with the summation order. There the test
  holds the port's psi error against an fp64 evaluation of the port's own
  moment code to the size of the JAX package's error against it;
- the KLD of equal Kent parameters, the Kent IoU and the loss: 1e-4
  absolute, the JAX suite's own tolerance between its kernels and their
  references, except at bitwise-identical pairs: there the KLD is ~0 and
  the IoU 1 / (1 + sqrt(KLD)) turns an fp32 rounding of 1e-6 in the KLD
  into 1e-3 (the JAX package's eager and jitted runs differ by 9e-4 on
  one such pair, ROADMAP C8); identical pairs are held to IoU > 0.99;
- gradients: 1e-4 absolute plus 1e-3 relative, on boxes away from every
  clamp (``jnp.clip`` passes half a gradient at an exact tie where
  ``torch.clamp`` passes all of it); at the poles, at 180-degree FoVs and
  at isotropic boxes the gradients are only required to be finite, batched,
  as the JAX package's own regression test requires.

The JAX side is jitted once a function and shape; its gradients are taken
eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.boxes import anchors as janchors
from sph_retina_tpu.geometry import generate_boxes
from sph_retina_tpu.iou import api as japi
from sph_retina_tpu.iou import kent as jkent
from sph_retina_tpu.models import single_stage as jss
from sph_retina_tpu_torch.boxes import anchors as tanchors
from sph_retina_tpu_torch.iou import api as tapi
from sph_retina_tpu_torch.iou import kent as tkent
from sph_retina_tpu_torch.models import single_stage as tss

from test_torch_fcos import one_cpu_step

ATOL = 1e-4
KAPPA_RTOL = 2e-3
GRAD_RTOL = 1e-3


def _boxes(n, d, seed, fov_range=(10.0, 80.0)):
    return generate_boxes(n, d, seed=seed, fov_range=fov_range,
                          phi_range=(20.0, 160.0))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _angle_error(a, b, period):
    return np.abs((a - b + period / 2) % period - period / 2)


def _assert_kent_params(got, want):
    got, want = np.asarray(got), np.asarray(want)
    kappa = want[..., 0]
    np.testing.assert_allclose(got[..., 0], kappa, rtol=KAPPA_RTOL, atol=0)
    assert (np.abs(got[..., 1] - want[..., 1]) <= KAPPA_RTOL * kappa).all()
    assert np.abs(got[..., 2] - want[..., 2]).max() <= ATOL
    assert _angle_error(got[..., 4], want[..., 4], 2 * np.pi).max() <= ATOL
    axis = want[..., 1] > 0.05 * kappa
    assert (_angle_error(got[..., 3], want[..., 3], np.pi)[axis] <= ATOL).all()
    return axis


@pytest.mark.parametrize("d", [4, 5])
def test_deg2kent_and_kent_mle_equal_the_jax_packages(d):
    boxes = _boxes(256, d, seed=d)
    want = jax.jit(jkent.deg2kent)(jnp.asarray(boxes))
    got = tkent.deg2kent(_t(boxes))
    assert got.shape == (256, 5) and got.dtype == torch.float32
    assert _assert_kent_params(got.numpy(), want).mean() > 0.5
    _assert_kent_params(tkent.kent_mle(_t(boxes)).numpy(),
                        jax.jit(jkent.kent_mle)(jnp.asarray(boxes)))
    g = tkent.kent_angles_to_gammas(got[:, 2], got[:, 3], got[:, 4])
    jg = jkent.kent_angles_to_gammas(*(jnp.asarray(got[:, i].numpy())
                                       for i in (2, 3, 4)))
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("d", [4, 5])
def test_deg2kent_of_narrow_boxes(d):
    """FoVs down to 2 degrees: kappa up to ~1e4, held relative; alpha and
    eta to 1e-4; psi's fp32 noise no larger than the JAX package's."""
    boxes = _boxes(256, d, seed=10 + d, fov_range=(2.0, 90.0))
    want = np.asarray(jax.jit(jkent.deg2kent)(jnp.asarray(boxes)))
    got = tkent.deg2kent(_t(boxes)).numpy()
    assert got[:, 0].max() > 1e3
    kappa = want[:, 0]
    np.testing.assert_allclose(got[:, 0], kappa, rtol=KAPPA_RTOL, atol=0)
    assert (np.abs(got[:, 1] - want[:, 1]) <= KAPPA_RTOL * kappa).all()
    assert np.abs(got[:, 2] - want[:, 2]).max() <= ATOL
    assert _angle_error(got[:, 4], want[:, 4], 2 * np.pi).max() <= ATOL
    # psi against the port's moment code in fp64
    rad = torch.deg2rad(torch.from_numpy(boxes).double())
    psi64 = tkent._kent_moments(rad)[3].numpy()
    axis = want[:, 1] > 0.05 * kappa
    port_err = _angle_error(got[:, 3], psi64, np.pi)[axis].max()
    jax_err = _angle_error(want[:, 3], psi64, np.pi)[axis].max()
    assert port_err <= 2.0 * jax_err + ATOL, (port_err, jax_err)


def test_kld_and_iou_equal_the_jax_packages():
    a, b = _boxes(128, 4, seed=11), _boxes(128, 4, seed=12)
    # the KLD alone, on the same Kent parameters on both sides
    ka = np.asarray(jkent.deg2kent(jnp.asarray(a)))
    kb = np.asarray(jkent.deg2kent(jnp.asarray(b)))
    want = np.asarray(jax.jit(jkent.kent_kld)(ka, kb))
    got = tkent.kent_kld(_t(ka), _t(kb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(tkent.kent_loss_terms(_t(ka), _t(kb)).numpy(),
                               np.asarray(jkent.kent_loss_terms(ka, kb)),
                               atol=ATOL, rtol=0)
    # the whole pipeline, boxes in
    np.testing.assert_allclose(
        tkent.kent_iou_elementwise(_t(a), _t(b)).numpy(),
        np.asarray(jax.jit(jkent.kent_iou_elementwise)(a, b)),
        atol=ATOL, rtol=0)


def test_golden_kld():
    """The fp64 KLDs of the original implementation for boxes[i] against
    boxes[i-1] (the first three), the JAX suite's golden values."""
    boxes = _t(generate_boxes(16, 4, seed=1, fov_range=(10, 80)))
    k = tkent.deg2kent(boxes)
    kld = tkent.kent_kld(k, torch.roll(k, 1, dims=0)).numpy()
    np.testing.assert_allclose(kld[:3], [0.746, 64.57, 4.781], rtol=0.02)
    self_kld = tkent.kent_kld(k, k).numpy()
    np.testing.assert_allclose(self_kld, 0.0, atol=1e-3)


@pytest.mark.parametrize("d", [4, 5])
def test_sph_overlaps_kent_aligned_and_pairwise(d):
    a, b = _boxes(40, d, seed=20 + d), _boxes(40, d, seed=30 + d)
    b[:5] = a[:5]  # bitwise-identical pairs
    identical = np.zeros((40, 40), bool)
    identical[np.arange(5), np.arange(5)] = True
    for aligned, (x, y), same in ((True, (a, b), identical.diagonal()),
                                  (False, (a[:12], b), identical[:12])):
        want = np.asarray(jax.jit(
            lambda p, q: japi.sph_overlaps(p, q, "kent", is_aligned=aligned))(
            jnp.asarray(x), jnp.asarray(y)))
        got = tapi.sph_overlaps(_t(x), _t(y), "kent_iou",
                                is_aligned=aligned).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got[~same], want[~same], atol=ATOL, rtol=0)
        assert got[same].min() > 0.99 and want[same].min() > 0.99
    # pairwise converts each side once and agrees with the aligned path
    pair = tapi.kent_iou(_t(a[:12]), _t(b)).numpy()
    aligned = tapi.sph_overlaps(_t(a[5:12]), _t(b[5:12]), "kent", True)
    np.testing.assert_allclose(pair[np.arange(5, 12), np.arange(5, 12)],
                               aligned.numpy(), atol=ATOL, rtol=0)


def test_kent_grid_anchors_equal_the_jax_packages():
    """The port's Kent anchors are its ``deg2kent`` of its grid anchors;
    against the JAX package's away from the poles (``center_offset`` 0
    puts the first row of centres on phi = 0, where eta is atan2 of two
    rounding residues in both packages; kappa, beta and alpha are compared
    there too)."""
    kw = dict(strides=[16, 32], ratios=[0.5, 1.0, 2.0], octave_base_scale=4,
              scales_per_octave=2)
    sizes = [(4, 8), (2, 4)]
    gen = tanchors.SphAnchorGenerator(**kw)
    got = tanchors.kent_grid_anchors(gen, sizes)
    want = jax.jit(lambda: janchors.kent_grid_anchors(
        janchors.SphAnchorGenerator(**kw), sizes))()
    assert len(got) == len(want) == 2
    for g, w, deg in zip(got, want, gen.grid_anchors(sizes)):
        assert tuple(g.shape) == w.shape == (deg.shape[0], 5)
        assert torch.equal(g, tkent.deg2kent(deg))
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=KAPPA_RTOL, atol=0)
        assert (np.abs(g[:, 1] - w[:, 1]) <= KAPPA_RTOL * w[:, 0]).all()
        assert np.abs(g[:, 2] - w[:, 2]).max() <= ATOL
        off_pole = (deg[:, 1] > 5.0).numpy() & (deg[:, 1] < 175.0).numpy()
        assert off_pole.any()
        _assert_kent_params(g[off_pole], w[off_pole])


@pytest.mark.parametrize("d", [4, 5])
def test_kent_loss_value_and_gradient_equal_the_jax_packages(d):
    pred, tgt = _boxes(24, d, seed=40), _boxes(24, d, seed=41)
    tgt[:12] = pred[:12] + np.float32(3.0)  # near pairs, KLD of order 1
    weight = (np.arange(24) % 5 != 0).astype(np.float32)
    kw = dict(avg_factor=7.0, loss_weight=2.0)

    want, want_grad = jax.jit(jax.value_and_grad(
        lambda p: jkent.sph_kent_loss(p, jnp.asarray(tgt),
                                      jnp.asarray(weight), **kw)))(
        jnp.asarray(pred))
    p = _t(pred).requires_grad_(True)
    got = tkent.sph_kent_loss(p, _t(tgt), _t(weight), **kw)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad),
                               atol=ATOL, rtol=GRAD_RTOL)
    # zero-weight rows carry no gradient
    assert float(p.grad[weight == 0].abs().sum()) == 0.0
    # no weight: the plain mean
    np.testing.assert_allclose(
        float(tkent.sph_kent_loss(_t(pred), _t(tgt))),
        float(jkent.sph_kent_loss(jnp.asarray(pred), jnp.asarray(tgt))),
        atol=ATOL, rtol=0)


# the JAX package's regression rows: decoded boxes on the phi and FoV clamps
# (pole centres, 180-degree FoVs, isotropic boxes), a zero-FoV row, an
# identical pair
DEGENERATE_PRED = np.array([
    [154.33, 0.0, 92.958, 139.925],
    [100.315, 180.0, 180.0, 180.0],
    [227.346, 39.285, 180.0, 180.0],
    [90.0, 90.0, 30.0, 30.0],
    [5.95, 0.493, 41.134, 69.042],
    [180.0, 90.0, 180.0, 180.0],
    [10.0, 1.0, 0.0, 0.0],
    [90.0, 90.0, 20.0, 20.0],
], np.float32)
DEGENERATE_TARGET = np.array([
    [5.95, 0.493, 41.134, 69.042],
    [100.0, 120.0, 40.0, 30.0],
    [229.306, 97.852, 63.159, 50.769],
    [91.0, 91.0, 28.0, 33.0],
    [6.0, 1.0, 40.0, 70.0],
    [182.0, 88.0, 40.0, 40.0],
    [12.0, 2.0, 25.0, 25.0],
    [90.0, 90.0, 20.0, 20.0],
], np.float32)


@pytest.mark.parametrize("reverse", [False, True], ids=["pred_target",
                                                       "target_pred"])
def test_kent_loss_gradients_finite_at_poles_180_and_isotropic(reverse):
    """One batch (the JAX package's NaNs showed batched and not row by
    row), both KLD directions; the zero-FoV row is zero-weighted and must
    get no gradient."""
    weight = torch.ones(len(DEGENERATE_PRED))
    weight[6] = 0.0
    p = _t(DEGENERATE_PRED).requires_grad_(True)
    t = _t(DEGENERATE_TARGET)
    args = (t, p) if reverse else (p, t)
    loss = tkent.sph_kent_loss(*args, weight, avg_factor=7.0)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(p.grad).all()
    assert float(p.grad[6].abs().sum()) == 0.0
    want = jkent.sph_kent_loss(
        *(jnp.asarray(np.asarray(a.detach())) for a in args),
        jnp.asarray(weight.numpy()), avg_factor=7.0)
    np.testing.assert_allclose(float(loss), float(want), atol=ATOL, rtol=0)
    # the pairwise IoU of the same boxes, and its gradient
    q = _t(DEGENERATE_PRED).requires_grad_(True)
    iou = tapi.sph_overlaps(q, _t(DEGENERATE_TARGET), "kent")
    iou.sum().backward()
    assert torch.isfinite(iou).all() and torch.isfinite(q.grad).all()


def test_anchor_targets_with_kent_assignment(monkeypatch):
    """``assign_backend="kent"``: the overlaps equal the JAX package's at
    1e-4, and fed the same overlaps (exact ties at a gt's best anchor,
    ROADMAP C3) the two assigners give the same targets."""
    b, max_gt, classes = 2, 6, 5
    kw = dict(img_size=(64, 128), assign_backend="kent_iou")
    jcfg = jss.retina_config(classes, **kw)
    tcfg = tss.retina_config(classes, **kw)
    boxes = np.stack([_boxes(max_gt, 4, seed=60 + i, fov_range=(15, 60))
                      for i in range(b)])
    labels = np.tile(np.arange(max_gt, dtype=np.int32) % classes, (b, 1))
    mask = np.stack([np.arange(max_gt) < 4, np.arange(max_gt) < 2])
    anchors = tcfg.flat_anchors()
    got_ov = tss._batch_pairwise_iou(_t(boxes), anchors, tcfg.assign_backend)
    want_ov = jax.jit(lambda g, a: jss._batch_pairwise_iou(
        g, a, jcfg.assign_backend))(jnp.asarray(boxes), jcfg.flat_anchors())
    np.testing.assert_allclose(got_ov.numpy(), np.asarray(want_ov),
                               atol=ATOL, rtol=0)
    assert float(got_ov.max()) > 0.3

    port_ov = got_ov.numpy()
    monkeypatch.setattr(jss, "_batch_pairwise_iou",
                        lambda gt, anc, backend: jnp.asarray(port_ov))
    want = jss.anchor_targets(jcfg, jcfg.flat_anchors(), jnp.asarray(boxes),
                              jnp.asarray(labels), jnp.asarray(mask))
    got = tss.anchor_targets(tcfg, anchors, _t(boxes),
                             torch.from_numpy(labels), torch.from_numpy(mask))
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert int(got.num_pos) > 0


@pytest.mark.parametrize("config, backend, loss", [
    ("sph_kent_retinanet_kld_120e_indoor360.py", "kent", "sph_kent_loss"),
    ("sph_kent_retinanet_r50_fpn_120e_indoor360.py", "kent", "sph_l1_loss"),
    ("sph_kent_retinanet_ciou_120e_indoor360.py", "kent",
     "sph2pob_iou_loss"),
    ("sph_kent_rotated_retinanet_r50_fpn_120e_indoor360.py",
     "sph2pob_efficient", "sph_l1_loss"),
])
def test_shipped_kent_config_builds_and_takes_one_cpu_step(config, backend,
                                                           loss):
    _, det_cfg, metrics = one_cpu_step(config)
    assert det_cfg.assign_backend == backend
    assert det_cfg.loss_bbox.func.__name__ == loss
    assert metrics["loss_bbox"] > 0.0

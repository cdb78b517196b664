"""The Gaussian losses of the PyTorch port vs the JAX package, on the CPU.

GWD, KLD and KFIoU on rotated boxes (``gwd_terms``, ``kld_terms``,
``kfiou_terms``, every option), their spherical wrappers after the Sph2Pob
transform (``sph2pob_gwd_loss``, ``sph2pob_kld_loss``, ``sph2pob_kf_loss``,
with ``center_weight``, weights and ``avg_factor``), and ``build_loss`` of
every type in the JAX package's ``LOSSES``. The same seeded numpy inputs go
through both packages; the JAX side runs eagerly. Tolerances: 1e-5 on the
closed-form terms of rotated boxes (values and gradients: scalar 2x2 algebra
in fp32), 1e-4 on the spherical losses and their gradients (the JAX suite's
own tolerance; the Sph2Pob transform's trigonometry comes first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu import losses as jlosses
from sph_retina_tpu.losses import gaussian_loss as jgauss
from sph_retina_tpu_torch import losses as tlosses
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.losses import gaussian_loss as tgauss

TERMS_TOL = 1e-5
TOL = 1e-4
K = 24


def _rotated_pairs(seed=0):
    """Rotated boxes (cx, cy, w, h, angle) in radians-sized units, the
    prediction near its target."""
    rng = np.random.default_rng(seed)
    target = np.stack([rng.uniform(-0.5, 0.5, K), rng.uniform(-0.5, 0.5, K),
                       rng.uniform(0.1, 0.8, K), rng.uniform(0.1, 0.8, K),
                       rng.uniform(-1.5, 1.5, K)], -1).astype(np.float32)
    pred = target + rng.normal(0, 0.05, target.shape).astype(np.float32)
    pred[:, 2:4] = np.abs(pred[:, 2:4])
    return pred, target


def _spherical_pairs(d, seed=0):
    rng = np.random.default_rng(seed)
    target = generate_boxes(K, d, seed=seed + 1, fov_range=(10.0, 60.0),
                            phi_range=(20.0, 160.0))
    pred = target + rng.normal(0, 3.0, target.shape).astype(np.float32)
    weight = rng.uniform(0.2, 1.0, K).astype(np.float32)
    weight[::6] = 0.0
    return pred.astype(np.float32), target, weight


def _value_and_grad_pair(jfn, tfn, pred, *rest):
    """(value, gradient w.r.t. pred) of the sum of each side."""
    jv, jg = jax.value_and_grad(lambda p: jnp.sum(jfn(p, *rest)))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    tv = tfn(p, *(torch.from_numpy(np.asarray(r)) for r in rest)).sum()
    tv.backward()
    return (float(tv), p.grad.numpy()), (float(jv), np.asarray(jg))


TERM_CASES = [
    ("gwd", dict()),
    ("gwd", dict(fun="sqrt", tau=2.0, alpha=0.5)),
    ("gwd", dict(fun="none", tau=0.0, normalize=False)),
    ("kld", dict()),
    ("kld", dict(fun="sqrt", tau=0.0, sqrt=False)),
    ("kld", dict(fun="none", tau=1.0)),
    ("kfiou", dict()),
    ("kfiou", dict(fun="ln")),
    ("kfiou", dict(fun="exp")),
]


@pytest.mark.parametrize("name, kw", TERM_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(TERM_CASES)])
def test_terms_of_rotated_boxes_equal_the_jax_packages(name, kw):
    pred, target = _rotated_pairs(seed=len(kw))
    jfn = getattr(jgauss, f"{name}_terms")
    tfn = getattr(tgauss, f"{name}_terms")
    j = jfn(jnp.asarray(pred), jnp.asarray(target), **kw)
    t = tfn(torch.from_numpy(pred), torch.from_numpy(target), **kw)
    assert tuple(t.shape) == (K,) and torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TERMS_TOL,
                               rtol=TERMS_TOL)
    (tv, tg), (jv, jg) = _value_and_grad_pair(
        lambda p, t_: jfn(p, t_, **kw), lambda p, t_: tfn(p, t_, **kw),
        pred, target)
    np.testing.assert_allclose(tv, jv, rtol=TERMS_TOL)
    np.testing.assert_allclose(tg, jg, atol=TERMS_TOL, rtol=TERMS_TOL)


def test_obb2gaussian_equals_the_jax_packages():
    pred, _ = _rotated_pairs()
    pred[0, 2] = 0.0  # a zero width is clamped to 1e-7
    jmu, jsig = jgauss.obb2gaussian(jnp.asarray(pred))
    tmu, tsig = tgauss.obb2gaussian(torch.from_numpy(pred))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=0)
    for a, b in zip(tsig, jsig):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=1e-6)


WRAPPER_CASES = [
    ("sph2pob_gwd_loss", 4, dict()),
    ("sph2pob_gwd_loss", 5, dict(center_weight=0.5, fun="sqrt", tau=2.0)),
    ("sph2pob_kld_loss", 4, dict(transform="sph2pob_efficient",
                                 avg_factor=5.0)),
    ("sph2pob_kld_loss", 5, dict(center_weight=1.0, loss_weight=2.0)),
    ("sph2pob_kf_loss", 4, dict(reduction="sum")),
    ("sph2pob_kf_loss", 5, dict(center_weight=0.25, fun="ln")),
]


@pytest.mark.parametrize("name, d, kw", WRAPPER_CASES,
                         ids=[f"{n}-{d}-{i}" for i, (n, d, _) in
                              enumerate(WRAPPER_CASES)])
def test_spherical_wrappers_equal_the_jax_packages(name, d, kw):
    pred, target, weight = _spherical_pairs(d, seed=d)
    jfn = getattr(jgauss, name)
    tfn = getattr(tgauss, name)
    (tv, tg), (jv, jg) = _value_and_grad_pair(
        lambda p, t, w: jfn(p, t, w, **kw), lambda p, t, w: tfn(p, t, w, **kw),
        pred, target, weight)
    assert np.isfinite(tv) and np.isfinite(tg).all()
    np.testing.assert_allclose(tv, jv, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tg, jg, atol=TOL, rtol=TOL)
    # the weight as one value a coordinate gives the same loss
    per_coordinate = torch.from_numpy(weight)[:, None].expand(K, d)
    np.testing.assert_allclose(
        float(tfn(torch.from_numpy(pred), torch.from_numpy(target),
                  per_coordinate, **kw)), tv, rtol=1e-6)


def test_build_loss_builds_every_type_of_the_jax_package():
    """Every key of the JAX package's ``LOSSES`` builds, to the port's
    function of the same name; ``Sph2PobGDLoss``'s ``loss_type`` picks GWD
    or KLD, as there; a built Gaussian or Kent loss gives the JAX package's
    value."""
    assert set(tlosses.LOSSES) == set(jlosses.LOSSES)
    for kind, jfn in jlosses.LOSSES.items():
        built = tlosses.build_loss({"type": kind, "use_sigmoid": True})
        assert built.func.__name__ == \
            (jfn.__name__ if kind != "KentLoss" else "sph_kent_loss"), kind
    assert tlosses.build_loss({"type": "Sph2PobGDLoss"}).func \
        is tgauss.sph2pob_gwd_loss
    gd_kld = tlosses.build_loss({"type": "Sph2PobGDLoss",
                                 "loss_type": "kld", "tau": 2.0})
    assert gd_kld.func is tgauss.sph2pob_kld_loss
    assert gd_kld.keywords == {"tau": 2.0}
    with pytest.raises(ValueError, match="unknown loss type 'Nope'"):
        tlosses.build_loss({"type": "Nope"})

    pred, target, weight = _spherical_pairs(4, seed=7)
    for cfg in ({"type": "Sph2PobGDLoss", "loss_type": "kld",
                 "loss_weight": 2.0},
                {"type": "Sph2PobGWDLoss", "center_weight": 0.5},
                {"type": "Sph2PobKFLoss"},
                {"type": "KentLoss", "const": 3.0}):
        want = jlosses.build_loss(cfg)(jnp.asarray(pred), jnp.asarray(target),
                                       jnp.asarray(weight))
        got = tlosses.build_loss(cfg)(torch.from_numpy(pred),
                                      torch.from_numpy(target),
                                      torch.from_numpy(weight))
        np.testing.assert_allclose(float(got), float(want), atol=TOL,
                                   rtol=TOL, err_msg=str(cfg))

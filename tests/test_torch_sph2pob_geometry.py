"""Spherical-box geometry of the PyTorch port vs the JAX package, on the CPU.

The box primitives, the two jitters, the three Sph2Pob transforms,
``standardize_spherical_box`` and the Sutherland-Hodgman rotated-box IoU. The
same numpy inputs, made from a seed, go through the JAX function and the
port. The JAX transforms are jitted once per variant and shape; the
rotated-box IoU runs eagerly (XLA on the CPU takes ~100 s to compile its
gradient, the eager gradient ~3 s). Tolerances:

- closed forms (primitives, jitters, transforms, corners, covers): 1e-5,
  except three columns of the legacy transform, held at 1e-4: box 2's
  longitude offset, ``2 asin(sqrt(sin^2(L/2) - sin^2(dlat/2)) / ...)``, a
  difference of two squares, and both angles, ``arccos`` of the cosine of two
  nearly parallel tangents. In fp32 both turn a 1-ulp difference in ``sin``
  between XLA and PyTorch into ~1e-5 radians (the JAX package's own eager
  and jitted runs differ by 2.8e-5 on this seed);
- rotated-box IoU values: 1e-4, the JAX suite's own tolerance;
- gradients: 1e-4 absolute on pairs away from the clamps and degenerate
  pairs; on identical and zero-area pairs they are finite, and the
  invariants of ``tests/test_rotated_iou.py`` hold (identical boxes IoU 1,
  edge-touching cells 0, two zero-area boxes 0, not NaN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.boxes import formator as jformator
from sph_retina_tpu.geometry import boxes as jboxes
from sph_retina_tpu.geometry import jitter as jjitter
from sph_retina_tpu.geometry import sph2pob as jsph2pob
from sph_retina_tpu.iou import rotated as jrotated
from sph_retina_tpu_torch.boxes import formator as tformator
from sph_retina_tpu_torch.geometry import boxes as tboxes
from sph_retina_tpu_torch.geometry import jitter as tjitter
from sph_retina_tpu_torch.geometry import sph2pob as tsph2pob
from sph_retina_tpu_torch.iou import rotated as trotated

CLOSED = 1e-5
IOU = 1e-4
GRAD = 1e-4
LEGACY_ILL_CONDITIONED = 1e-4
VARIANTS = ("sph2pob_standard", "sph2pob_efficient", "sph2pob_legacy")


def _boxes(n, d, seed):
    return tboxes.generate_boxes(n, d, seed=seed)


def _pairs(n, d, seed, n_similar=4):
    """Seeded pairs; the first ``n_similar`` share one coordinate exactly,
    so that the jitter moves them."""
    b1, b2 = _boxes(n, d, seed), _boxes(n, d, seed + 100)
    b2[:n_similar, 1] = b1[:n_similar, 1]
    return b1, b2


def _rotated(n, seed, w_range=(0.1, 2.0)):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                     rng.uniform(*w_range, n), rng.uniform(*w_range, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def _t(*arrays, grad=False):
    out = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)
           for a in arrays]
    return out if len(out) > 1 else out[0]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=atol, rtol=0)


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #
def _vec(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


PRIMITIVES = {
    "sph_to_unit_vec": lambda m: (m.sph_to_unit_vec, _vec(32, 0)[:, 0],
                                  _vec(32, 1)[:, 0]),
    "longitude_tangent": lambda m: (m.longitude_tangent, _vec(32, 2)[:, 0],
                                    _vec(32, 3)[:, 0]),
    "unit_vec_to_sph": lambda m: (m.unit_vec_to_sph, _vec(32, 4)),
    "normalize": lambda m: (m.normalize, _vec(32, 5)),
    "angle_between": lambda m: (m.angle_between, _vec(32, 6), _vec(32, 7)),
    "rotation_sign": lambda m: (m.rotation_sign, _vec(32, 8), _vec(32, 9),
                                _vec(32, 10)),
    "spherical_box_area": lambda m: (
        m.spherical_box_area, np.deg2rad(_boxes(32, 4, 11)[:, 2]),
        np.deg2rad(_boxes(32, 4, 12)[:, 3])),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_box_primitives_equal_the_jax_packages(name):
    jfn, *args = PRIMITIVES[name](jboxes)
    tfn = PRIMITIVES[name](tboxes)[0]
    want = jfn(*(jnp.asarray(a) for a in args))
    got = tfn(*(_t(np.asarray(a, np.float32)) for a in args))
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, CLOSED)


def test_angle_between_identical_directions_is_small_and_finite():
    v = _t(_vec(8, 13), grad=True)
    ang = tboxes.angle_between(v, v.detach().clone())
    assert float(ang.min()) > 0.0  # clipped to 1 - 1e-7, not exactly 0
    ang.sum().backward()
    assert torch.isfinite(v.grad).all()


@pytest.mark.parametrize("d", [4, 5])
def test_standardize_spherical_box(d):
    b1, b2 = _pairs(64, d, seed=20)
    b1[:8, 0] = np.float32(2.0)  # straddle the seam
    b2[:8, 0] = np.float32(358.0)
    want = jboxes.standardize_spherical_box(jnp.asarray(b1), jnp.asarray(b2))
    got = tboxes.standardize_spherical_box(*_t(b1, b2))
    for g, w in zip(got, want):
        _close(g, w, CLOSED)
    assert bool((got[0][:8, 0] == 182.0).all())
    assert bool((got[1][:8, 0] == 178.0).all())


# --------------------------------------------------------------------------- #
# jitters
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [4, 5])
def test_jitter_spherical_boxes(d):
    b1, b2 = _pairs(64, d, seed=30)
    b2[4:8] = b1[4:8]                      # identical
    b1[8, 0], b2[9, 1] = 0.0, 180.0        # on the clamps
    want = jjitter.jitter_spherical_boxes(jnp.asarray(b1), jnp.asarray(b2))
    got = tjitter.jitter_spherical_boxes(*_t(b1, b2))
    for g, w in zip(got, want):
        _close(g, w, CLOSED)
    moved = (got[0] != torch.from_numpy(b1)).any(-1)
    assert bool(moved[:8].all())


def test_jitter_rotated_boxes():
    p1, p2 = _rotated(64, seed=31), _rotated(64, seed=32)
    p2[:4] = p1[:4]                                   # identical
    p2[4:8, 4] = p1[4:8, 4] + np.float32(5e-4)        # angles close
    p1[8:10, 2:4] = np.float32(0.0)                   # zero-sized
    want = jjitter.jitter_rotated_boxes(jnp.asarray(p1), jnp.asarray(p2))
    got = tjitter.jitter_rotated_boxes(*_t(p1, p2))
    for g, w in zip(got, want):
        _close(g, w, CLOSED)


def test_the_jitter_constants_are_the_jax_packages():
    assert tjitter._EPS == jjitter._EPS == 1e-4 * 1.2345678
    assert tjitter._ANG_EPS == jjitter._ANG_EPS == 1e-3 * 1.2345678


# --------------------------------------------------------------------------- #
# Sph2Pob transforms
# --------------------------------------------------------------------------- #
def _jitter_rad(b1, b2):
    j1, j2 = tjitter.jitter_spherical_boxes(*_t(b1, b2))
    return np.deg2rad(j1.numpy()), np.deg2rad(j2.numpy())


_JIT_TRANSFORMS = {
    (v, e, a): jax.jit(lambda x, y, v=v, e=e, a=a: getattr(jsph2pob, v)(
        x, y, rbb_edge=e, rbb_angle=a))
    for v in VARIANTS for e in ("arc", "tangent", "chord")
    for a in ("equator", "project")}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("d", [4, 5])
@pytest.mark.parametrize("edge, angle", [("arc", "equator"),
                                         ("tangent", "project"),
                                         ("chord", "equator")])
def test_sph2pob_transforms_equal_the_jax_packages(variant, d, edge, angle):
    r1, r2 = _jitter_rad(*_pairs(48, d, seed=40 + d))
    want = _JIT_TRANSFORMS[variant, edge, angle](jnp.asarray(r1),
                                                 jnp.asarray(r2))
    got = getattr(tsph2pob, variant)(*_t(r1, r2), rbb_edge=edge,
                                     rbb_angle=angle)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (48, 5)
    for g, w, cols in zip(got, want, ([4], [0, 4])):
        if variant == "sph2pob_legacy":
            _close(g[:, cols], np.asarray(w)[:, cols], LEGACY_ILL_CONDITIONED)
            keep = [c for c in range(5) if c not in cols]
            g, w = g[:, keep], np.asarray(w)[:, keep]
        _close(g, w, CLOSED)


def test_sph2pob_standard_coincident_centres_take_the_midpoint_frame():
    """Boxes with the same centre but other sides: the pair frame is
    degenerate, the look-at frame takes over, and the dummy difference keeps
    the gradient finite. Each centre lands on +x, where the sign of its
    longitude (+-4.9e-4, the arccos clip) is decided by rounding noise: it is
    compared by magnitude."""
    b1 = _boxes(8, 5, seed=45)
    b2 = b1.copy()
    b2[:, 2:] += np.float32(7.0)
    r1, r2 = np.deg2rad(b1), np.deg2rad(b2)
    want = _JIT_TRANSFORMS["sph2pob_standard", "arc", "equator"](
        jnp.asarray(r1), jnp.asarray(r2))
    t1, t2 = _t(r1, r2, grad=True)
    got = tsph2pob.sph2pob_standard(t1, t2)
    for g, w in zip(got, want):
        _close(g[:, 1:], np.asarray(w)[:, 1:], CLOSED)
        _close(g[:, 0].abs(), np.abs(np.asarray(w)[:, 0]), CLOSED)
        assert float(g[:, 0].abs().max()) < 1e-3
    sum(g.sum() for g in got).backward()
    assert torch.isfinite(t1.grad).all() and torch.isfinite(t2.grad).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_sph2pob_transform_gradients_equal_the_jax_packages(variant):
    r1, r2 = _jitter_rad(*_pairs(32, 5, seed=50, n_similar=0))
    w = np.random.default_rng(51).normal(size=(32, 5)).astype(np.float32)

    def jloss(a, b):
        p1, p2 = getattr(jsph2pob, variant)(a, b)
        return jnp.sum((p1 + p2) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(r1),
                                                     jnp.asarray(r2))
    t1, t2 = _t(r1, r2, grad=True)
    p1, p2 = getattr(tsph2pob, variant)(t1, t2)
    ((p1 + p2) * torch.from_numpy(w)).sum().backward()
    _close(t1.grad, want[0], GRAD)
    _close(t2.grad, want[1], GRAD)


# --------------------------------------------------------------------------- #
# rotated boxes: corners, covers, Sutherland-Hodgman IoU
# --------------------------------------------------------------------------- #
def test_corners_covers_and_formats_equal_the_jax_packages():
    p = _rotated(40, seed=60)
    _close(trotated.box_corners(_t(p)), jrotated.box_corners(jnp.asarray(p)),
           CLOSED)
    _close(tformator.obb2hbb_xywh(_t(p)),
           jformator.obb2hbb_xywh(jnp.asarray(p)), CLOSED)
    _close(tformator.obb2hbb_xyxy(_t(p)),
           jformator.obb2hbb_xyxy(jnp.asarray(p)), CLOSED)
    xyxy = np.asarray(jformator.obb2hbb_xyxy(jnp.asarray(p)))
    _close(tformator.xyxy2xywh(_t(xyxy)),
           jformator.xyxy2xywh(jnp.asarray(xyxy)), CLOSED)


def test_rotated_box_iou_aligned_and_pairwise_equal_the_jax_packages():
    p1, p2 = _rotated(64, seed=61), _rotated(48, seed=62)
    want = jrotated.rotated_box_iou(jnp.asarray(p1[:48]), jnp.asarray(p2))
    got = trotated.rotated_box_iou(*_t(p1[:48], p2))
    assert got.shape == (48,) and float(got.max()) > 0.3
    _close(got, want, IOU)
    want = jrotated.rotated_box_iou(jnp.asarray(p1[:, None]),
                                    jnp.asarray(p2[None]))
    got = trotated.rotated_box_iou(*_t(p1[:, None], p2[None]))
    assert got.shape == (64, 48)
    _close(got, want, IOU)
    corners = [trotated.box_corners(t) for t in _t(p1[:48], p2)]
    _close(trotated.rotated_box_intersection(*corners),
           jrotated.rotated_box_intersection(
               jrotated.box_corners(jnp.asarray(p1[:48])),
               jrotated.box_corners(jnp.asarray(p2))), IOU)


def test_rotated_box_iou_gradients_equal_the_jax_packages():
    p1, p2 = _rotated(48, seed=63), _rotated(48, seed=64)
    p2[:, :2] = p1[:, :2] + np.float32(0.2) * p2[:, :2]  # overlapping
    want = jax.grad(lambda a, b: jnp.sum(
        jrotated.rotated_box_iou(a, b)), argnums=(0, 1))(
        jnp.asarray(p1), jnp.asarray(p2))
    t1, t2 = _t(p1, p2, grad=True)
    iou = trotated.rotated_box_iou(t1, t2)
    assert float(iou.min()) > 0.0
    iou.sum().backward()
    _close(t1.grad, want[0], GRAD)
    _close(t2.grad, want[1], GRAD)


def test_rotated_box_iou_degenerate_pairs():
    """Identical boxes give 1, edge-touching cells 0, two zero-area boxes 0
    (not NaN); gradients finite throughout."""
    p = _rotated(16, seed=65)
    touching = np.array([[0.0, 0.0, 1.0, 1.0, 0.0]], np.float32)
    neighbour = np.array([[1.0, 0.0, 1.0, 1.0, 0.0]], np.float32)
    flat = np.array([[0.3, 0.3, 0.0, 0.0, 0.2]], np.float32)
    a = np.concatenate([p, touching, flat, flat])
    b = np.concatenate([p, neighbour, flat, flat + np.float32(0.1)])
    ta, tb = _t(a, b, grad=True)
    iou = trotated.rotated_box_iou(ta, tb)
    want = np.asarray(jrotated.rotated_box_iou(jnp.asarray(a), jnp.asarray(b)))
    assert np.isfinite(want).all()
    got = iou.detach().numpy()
    np.testing.assert_allclose(got[:16], 1.0, atol=IOU)
    assert got[16] == pytest.approx(0.0, abs=IOU)
    assert got[17] == 0.0 and got[18] == 0.0
    _close(got, want, IOU)
    iou.sum().backward()
    assert torch.isfinite(ta.grad).all() and torch.isfinite(tb.grad).all()

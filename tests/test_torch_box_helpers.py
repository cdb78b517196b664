"""The box-format helpers and the validity predicate of the port against the
JAX package's: the seven chart conversions of ``boxes/formator.py`` at D=4
and D=5 (1e-5), their round trips, and ``geometry.is_valid_boxes`` at its
inclusive bounds (flags equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu import boxes as jboxes
from sph_retina_tpu import geometry as jgeometry
from sph_retina_tpu_torch import boxes as tboxes
from sph_retina_tpu_torch import geometry as tgeometry
from sph_retina_tpu_torch.geometry import generate_boxes

TOL = 1e-5
IMG_SIZES = [(512, 1024), (96, 192)]


def _both(name, x, *args, **kwargs):
    got = getattr(tboxes, name)(torch.from_numpy(x), *args, **kwargs)
    want = getattr(jboxes, name)(jnp.asarray(x), *args, **kwargs)
    return got.numpy(), np.asarray(want)


def _planar(n, seed):
    """(n, 4) xyxy boxes inside a 512x1024 chart."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, 900, n)
    y1 = rng.uniform(0, 450, n)
    return np.stack([x1, y1, x1 + rng.uniform(2, 120, n),
                     y1 + rng.uniform(2, 60, n)], -1).astype(np.float32)


@pytest.mark.parametrize("d", [4, 5])
def test_bfov2rbfov_and_the_geographic_charts(d):
    b = generate_boxes(64, d, seed=d)
    got, want = _both("bfov2rbfov", b[:, :4])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert got.shape == (64, 5) and (got[:, 4] == 0).all()
    for name in ("geo2sph", "sph2geo"):
        x = b.copy()
        got, want = _both(name, x)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        np.testing.assert_array_equal(x, b)  # the input is not written
    t = torch.from_numpy(b)
    np.testing.assert_allclose(tboxes.geo2sph(tboxes.sph2geo(t)).numpy(), b,
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("img_size", IMG_SIZES)
@pytest.mark.parametrize("name", ["sph2pix_box_transform",
                                  "sph2tan_box_transform"])
def test_chart_transforms_and_their_round_trips(name, img_size):
    b = generate_boxes(64, 4, seed=1, fov_range=(1.0, 170.0))
    got, want = _both(name, b, img_size)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=1e-6)
    inverse = {"sph2pix_box_transform": "pix2sph_box_transform",
               "sph2tan_box_transform": "tan2sph_box_transform"}[name]
    back, back_jax = _both(inverse, got, img_size)
    np.testing.assert_allclose(back, back_jax, atol=TOL, rtol=1e-6)
    np.testing.assert_allclose(back, b, atol=1e-3, rtol=0)


@pytest.mark.parametrize("img_size", IMG_SIZES)
@pytest.mark.parametrize("mode", ["sph2pix", "pix2sph", "sph2tan",
                                  "tan2sph"])
@pytest.mark.parametrize("d", [4, 5])
def test_planar2sph_boxes(mode, d, img_size):
    x = _planar(48, seed=2)
    got, want = _both("planar2sph_boxes", x, mode, d, img_size)
    assert got.shape == (48, d)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=1e-6)
    if mode in ("sph2pix", "pix2sph"):  # xyxy -> degrees -> xyxy
        again = tboxes.sph2planar_boxes(torch.from_numpy(got[:, :4]),
                                        img_size).numpy()
        np.testing.assert_allclose(again, x, atol=1e-2, rtol=0)


def _below(v):
    """The float32 next below ``v``; below 0 the smallest normal number's
    negative, as XLA on the CPU flushes denormals to zero."""
    return np.float32(-1e-30) if v == 0 else np.nextafter(np.float32(v),
                                                          -np.inf)


def _edge_boxes(d):
    """Every coordinate at, just inside and just outside each bound."""
    lo = [0.0, 0.0, 0.0, 0.0, -180.0][:d]
    hi = [360.0, 180.0, 360.0, 180.0, 180.0][:d]
    base = np.array([100.0, 90.0, 30.0, 20.0, 10.0][:d], np.float32)
    rows = [base]
    for c in range(d):
        for v in (lo[c], hi[c], _below(lo[c]),
                  np.nextafter(np.float32(hi[c]), np.inf),
                  lo[c] + 1e-3, hi[c] - 1e-3):
            row = base.copy()
            row[c] = v
            rows.append(row)
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("d", [4, 5])
def test_is_valid_boxes_at_the_inclusive_bounds(d):
    boxes = _edge_boxes(d)
    got = tgeometry.is_valid_boxes(torch.from_numpy(boxes), need_flag=True)
    want = np.asarray(jgeometry.is_valid_boxes(jnp.asarray(boxes),
                                               need_flag=True))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # valid: the base row, each bound itself and just inside it
    expected = np.array([True] + [True, True, False, False, True, True] * d)
    np.testing.assert_array_equal(got.numpy(), expected)
    for rows in (boxes[got.numpy()], boxes):
        assert bool(tgeometry.is_valid_boxes(torch.from_numpy(rows))) \
            == bool(jgeometry.is_valid_boxes(jnp.asarray(rows)))

"""PyTorch port of the fused Sph2Pob IoU vs the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
``sph_retina_tpu_torch``. Tolerances:

- 1e-5 against ``fused_sph2pob_iou`` run eagerly (the same arithmetic in the
  same order, op by op; what remains is each library's sin/cos/rsqrt),
  on generic (non-degenerate) pairs;
- 1e-4 against the Pallas pairwise kernel in interpret mode (the tolerance
  the JAX suite holds that kernel to against its own jnp path);
- bitwise-identical and grid-adjacent boxes sit on the jitter thresholds,
  where the JAX package's own eager and jitted runs differ beyond 1e-4; for
  those the invariants of ``tests/test_rotated_iou.py`` are asserted on the
  port (range, identical ~1, touching ~0) and a 5e-3 agreement.
"""

import itertools
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.geometry import generate_boxes
from sph_retina_tpu.ops import sph2pob_iou_pairwise_tpu
from sph_retina_tpu.ops.fused_iou import arccos_poly as jax_arccos_poly
from sph_retina_tpu.ops.fused_iou import fused_sph2pob_iou as jax_fused
from sph_retina_tpu_torch.ops import fused_iou as tf
from sph_retina_tpu_torch.ops import (
    fused_sph2pob_iou,
    sph2pob_iou_pairwise,
    sph2pob_iou_pairwise_plain,
)

SHAPES = [(20, 12), (7, 5)]


def _jax_pairwise(b1, b2):
    d = b1.shape[1]
    return np.asarray(jax_fused(
        [jnp.asarray(b1[:, c])[:, None] for c in range(d)],
        [jnp.asarray(b2[:, c])[None, :] for c in range(d)]))


@pytest.mark.parametrize("version", [4, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_pairwise_plain_matches_jax_fused(version, shape):
    b1 = generate_boxes(shape[0], version, seed=1)
    b2 = generate_boxes(shape[1], version, seed=2)
    ref = _jax_pairwise(b1, b2)
    got = sph2pob_iou_pairwise_plain(torch.from_numpy(b1),
                                     torch.from_numpy(b2)).numpy()
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("version", [4, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_pairwise_plain_matches_pallas_interpret(version, shape):
    b1 = generate_boxes(shape[0], version, seed=1)
    b2 = generate_boxes(shape[1], version, seed=2)
    ref = np.asarray(sph2pob_iou_pairwise_tpu(
        jnp.asarray(b1), jnp.asarray(b2), interpret=True, tile_n=8,
        tile_m=128))
    got = sph2pob_iou_pairwise_plain(torch.from_numpy(b1),
                                     torch.from_numpy(b2)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("version", [4, 5])
def test_aligned_components_match_jax_fused(version):
    """The componentwise entry on (N,) vectors: matched pairs."""
    b1 = generate_boxes(40, version, seed=3)
    b2 = generate_boxes(40, version, seed=4)
    ref = np.asarray(jax_fused([jnp.asarray(b1[:, c]) for c in range(version)],
                               [jnp.asarray(b2[:, c]) for c in range(version)]))
    got = fused_sph2pob_iou(
        [torch.from_numpy(b1[:, c].copy()) for c in range(version)],
        [torch.from_numpy(b2[:, c].copy()) for c in range(version)]).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("version", [4, 5])
def test_pairs_on_a_lattice_take_the_jitter_branches(version):
    """Coordinates drawn from a coarse lattice: most pairs share a longitude,
    a side length or a rotation, which sends them through the degree-space
    jitter, the rotated-box jitter and the angle jitter. No pair shares a
    boundary run, but boxes of equal sides on one meridian have edges that
    nearly coincide, so the tolerance is 5e-5 here (3 of 1920 pairs differ
    by 1.7e-5; a jitter constant that is off shows as 1e-4)."""
    rng = np.random.default_rng(version)

    def lattice(n):
        cols = [rng.choice(np.arange(15.0, 360.0, 45.0), n),
                rng.uniform(20.0, 160.0, n),
                rng.choice([10.0, 25.0, 40.0], n),
                rng.choice([12.0, 30.0], n)]
        if version == 5:
            cols.append(rng.choice([-30.0, 0.0, 45.0], n))
        return np.stack(cols, 1).astype(np.float32)

    b1, b2 = lattice(48), lattice(40)
    t1 = [torch.from_numpy(b1[:, c].copy())[:, None] for c in range(version)]
    t2 = [torch.from_numpy(b2[:, c].copy())[None, :] for c in range(version)]
    # the branches are really taken, by a good share of the pairs
    j1, _ = tf._jitter_spherical(t1, t2)
    assert 0.5 < float((j1[0] != t1[0]).float().mean()) < 1.0
    got = sph2pob_iou_pairwise_plain(torch.from_numpy(b1),
                                     torch.from_numpy(b2)).numpy()
    assert 0.02 < (got > 0.05).mean()  # and a good share of them overlap
    np.testing.assert_allclose(got, _jax_pairwise(b1, b2), atol=5e-5, rtol=0)


def test_arccos_poly_matches_jax_and_numpy():
    x = np.linspace(-0.9999, 0.9999, 4001).astype(np.float32)
    got = tf.arccos_poly(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_arccos_poly(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, np.arccos(x), atol=2e-5, rtol=0)


def test_degenerate_pairs_keep_the_invariants():
    rng = np.random.default_rng(11)
    n = 64
    base = np.stack([
        rng.uniform(5, 355, n), rng.uniform(5, 175, n),
        rng.uniform(5, 90, n), rng.uniform(5, 90, n),
    ], -1).astype(np.float32)
    tb = torch.from_numpy(base)

    # bitwise-identical pairs
    ident = sph2pob_iou_pairwise_plain(tb, tb).numpy()
    assert np.all(ident >= 0.0) and np.all(ident <= 1.0)
    assert np.all(np.diag(ident) > 0.95)
    np.testing.assert_allclose(ident, _jax_pairwise(base, base), atol=5e-3,
                               rtol=0)

    # grid-adjacent boxes sharing one exact boundary meridian
    a = np.array([[80.0, 90.0, 20.0, 20.0]], np.float32)
    b = np.array([[100.0, 90.0, 20.0, 20.0]], np.float32)
    adj = float(sph2pob_iou_pairwise_plain(torch.from_numpy(a),
                                           torch.from_numpy(b))[0, 0])
    assert 0.0 <= adj < 0.05

    # a grid of touching cells
    cells = np.array([[t, p, 30.0, 30.0]
                      for t, p in itertools.product(
                          np.arange(30.0, 180.0, 30.0),
                          np.arange(45.0, 135.0, 30.0))], np.float32)
    mat = sph2pob_iou_pairwise_plain(torch.from_numpy(cells),
                                     torch.from_numpy(cells)).numpy()
    assert np.all(mat >= 0.0) and np.all(mat <= 1.0)
    assert np.all(np.diag(mat) > 0.95)
    np.testing.assert_allclose(mat, _jax_pairwise(cells, cells), atol=5e-3,
                               rtol=0)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    b1 = torch.from_numpy(generate_boxes(9, 5, seed=7))
    b2 = torch.from_numpy(generate_boxes(4, 5, seed=8))
    before = sph2pob_iou_pairwise.launches
    got = sph2pob_iou_pairwise(b1, b2)
    assert sph2pob_iou_pairwise.launches == before
    assert torch.equal(got, sph2pob_iou_pairwise_plain(b1, b2))


@pytest.mark.parametrize("bad", [
    lambda b: (b.double(), b),                      # dtype
    lambda b: (b[:, :3].contiguous(), b),           # width
    lambda b: (b.t().contiguous().t(), b),          # contiguity
    lambda b: (b, torch.cat([b, b[:, :1]], 1)),     # D differs
    lambda b: (b.numpy(), b),                       # not a tensor
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b = torch.from_numpy(generate_boxes(6, 4, seed=9))
    with pytest.raises((TypeError, ValueError)):
        sph2pob_iou_pairwise(*bad(b))


def test_kernel_header_constants_match_the_plain_version():
    """``csrc/sph2pob_pair.cuh`` states its constants as literals; they must
    be the plain version's (the kernel cannot be run without a card, its
    constants can be read)."""
    path = os.path.join(os.path.dirname(tf.__file__), "..", "csrc",
                        "sph2pob_pair.cuh")
    with open(path) as f:
        src = f.read()

    def literal(name):
        m = re.search(rf"constexpr float {name} = \(float\)([0-9.eE+-]+);", src)
        assert m, name
        return float(m.group(1))

    eps, ang = tf._EPS, tf._ANG_EPS
    for name, want in [
        ("kCosE1", math.cos(eps)), ("kSinE1", math.sin(eps)),
        ("kCosE5", math.cos(5 * eps)), ("kSinE5", math.sin(5 * eps)),
        ("kCosA1", math.cos(ang)), ("kSinA1", math.sin(ang)),
        ("kCosA2", math.cos(2 * ang)), ("kSinA2", math.sin(2 * ang)),
    ]:
        assert np.float32(literal(name)) == np.float32(want), name
    assert "kEpsD = 1e-4 * 1.2345678;" in src and eps == 1e-4 * 1.2345678
    assert "kAngEpsD = 1e-3 * 1.2345678;" in src and ang == 1e-3 * 1.2345678
    assert "kCosEpsD = 1e-7;" in src and tf._COS_EPS == 1e-7

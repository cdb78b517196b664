"""The Sph2Pob-IoU kernels' cull of disjoint pairs, on the CPU.

``sph2pob_disjoint_plain`` is the predicate with which both CUDA kernels skip
a pair and store 0.0 in its place (``csrc/sph2pob_pair.cuh``, ``disjoint``).
The kernels stay equal to their plain versions bit for bit only if the
predicate names no pair whose plain IoU is not exactly 0.0. That is held here
on inputs made to press it: seeded uniform boxes, pairs placed along a
meridian just beyond and just within the margin, boxes of 1e-3 degree, boxes
at the poles and across the 0/360 seam, bitwise-identical pairs (the jittered
state) and the trainer's padding box against the shipped config's first
anchor rows. There the JAX package's ``fused_sph2pob_iou``, run eagerly once
for each box width on every culled pair, is at most 1e-4 (the tolerance the
JAX suite holds its Pallas kernels to).
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.ops.fused_iou import fused_sph2pob_iou as jax_fused
from sph_retina_tpu_torch.engine.builder import build_detector_config
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.ops import fused_iou as tf
from sph_retina_tpu_torch.ops import (
    sph2pob_disjoint_plain,
    sph2pob_iou_aligned_plain,
    sph2pob_iou_pairwise_plain,
)
from sph_retina_tpu_torch.utils.config import load_config

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs",
                      "sph_rotated_retinanet_r50_fpn_120e_pandora.py")
MARGIN_DEG = math.degrees(tf._CULL_MARGIN)


def _boxes(cols, d, rng):
    """Stack columns (theta, phi, alpha, beta) and, for D=5, a random gamma."""
    n = len(cols[0])
    if d == 5:
        cols = list(cols) + [rng.uniform(-90.0, 90.0, n)]
    return np.stack(cols, 1).astype(np.float32)


def _uniform(d):
    return (generate_boxes(60, d, seed=1), generate_boxes(70, d, seed=2))


def _meridian(d):
    """Pairs on one meridian (and 0.01 degree off it, out of the jitter),
    their centres R1 + R2 + margin * (1 +- 0.01) apart: pair k is row k of
    both sets."""
    rng = np.random.default_rng(3)
    n = 96
    side = lambda: 10.0 ** rng.uniform(-3.0, 2.0, n)  # noqa: E731
    a1, b1, a2, b2 = side(), side(), side(), side()
    r = lambda a, b: 0.5 * np.hypot(a, b)  # noqa: E731
    gap = r(a1, b1) + r(a2, b2) + MARGIN_DEG * np.where(
        np.arange(n) % 2 == 0, 1.01, 0.99)
    phi1 = rng.uniform(0.5, 179.5 - gap)
    theta = rng.uniform(0.0, 360.0, n)
    off = np.where(np.arange(n) % 4 < 2, 0.0, 0.01)
    return (_boxes([theta, phi1, a1, b1], d, rng),
            _boxes([theta + off, phi1 + gap, a2, b2], d, rng))


def _tiny(d):
    """1e-3 degree boxes: a cluster within 0.01 degree and a spread."""
    rng = np.random.default_rng(4)
    n = 64
    theta = np.concatenate([100.0 + rng.uniform(-0.01, 0.01, n // 2),
                            rng.uniform(0.0, 360.0, n // 2)])
    phi = np.concatenate([60.0 + rng.uniform(-0.01, 0.01, n // 2),
                          rng.uniform(0.0, 180.0, n // 2)])
    size = np.full(n, 1e-3)
    b = _boxes([theta, phi, size, size], d, rng)
    return b, b[::-1].copy()


def _poles_and_seam(d):
    rng = np.random.default_rng(5)
    thetas = [0.0, 1e-4, 0.5, 180.0, 359.5, 359.9999, 360.0]
    phis = [0.0, 1e-4, 0.3, 2.0, 178.0, 179.7, 179.9999, 180.0]
    grid = np.array([(t, p) for t in thetas for p in phis])
    n = len(grid)
    b1 = _boxes([grid[:, 0], grid[:, 1], rng.uniform(0.5, 60.0, n),
                 rng.uniform(0.5, 60.0, n)], d, rng)
    b2 = _boxes([grid[::-1, 0], grid[::-1, 1], rng.uniform(0.5, 60.0, n),
                 rng.uniform(0.5, 60.0, n)], d, rng)
    return b1, b2


def _identical(d):
    b = generate_boxes(80, d, seed=6, fov_range=(0.5, 40.0))
    return b, b.copy()


_ANCHORS = {}


def _padding_vs_anchors(d):
    """The all-1.0 box that pads the trainer's gts (``pad_gt``), and a few
    gts, against the shipped config's first anchor rows: phi = 0 (the pole,
    where every anchor meets the padding box) and the rows down to 12
    degrees."""
    if "a" not in _ANCHORS:
        det = build_detector_config(load_config(CONFIG))
        _ANCHORS["a"] = det.flat_anchors().numpy()
    anchors = _ANCHORS["a"]
    pole = anchors[anchors[:, 1] == 0.0][:300, :d]
    near = anchors[(anchors[:, 1] > 0.0) & (anchors[:, 1] <= 12.0)][::7, :d]
    first = np.concatenate([pole, near[:600]])
    gts = np.concatenate([np.ones((4, d), np.float32),
                          generate_boxes(4, d, seed=7, phi_range=(0.0, 20.0),
                                         fov_range=(10.0, 60.0))])
    return gts, np.ascontiguousarray(first)


INPUTS = {
    "uniform": _uniform,
    "meridian": _meridian,
    "tiny": _tiny,
    "poles_and_seam": _poles_and_seam,
    "identical": _identical,
    "padding_vs_anchors": _padding_vs_anchors,
}


def _culled(b1, b2):
    """The predicate and the plain IoU over all (N, M) pairs."""
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    mask = sph2pob_disjoint_plain(t1[:, None], t2[None])
    iou = sph2pob_iou_pairwise_plain(t1, t2)
    return mask, iou


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("d", [4, 5])
def test_culled_pairs_have_plain_iou_exactly_zero(d, name):
    b1, b2 = INPUTS[name](d)
    mask, iou = _culled(b1, b2)
    assert mask.shape == iou.shape == (len(b1), len(b2))
    assert bool((iou[mask] == 0.0).all()), \
        f"culled pairs with IoU {iou[mask][iou[mask] != 0.0][:5].tolist()}"
    # the same pairs matched one to one through the aligned plain version
    rows, cols = torch.meshgrid(torch.arange(len(b1)), torch.arange(len(b2)),
                                indexing="ij")
    p1 = torch.from_numpy(b1)[rows.flatten()].contiguous()
    p2 = torch.from_numpy(b2)[cols.flatten()].contiguous()
    flat = sph2pob_disjoint_plain(p1, p2)
    assert torch.equal(flat, mask.flatten())
    assert bool((sph2pob_iou_aligned_plain(p1, p2)[flat] == 0.0).all())


@pytest.mark.parametrize("d", [4, 5])
def test_culled_pairs_are_zero_in_the_jax_package(d):
    pairs1, pairs2 = [], []
    for make in INPUTS.values():
        b1, b2 = make(d)
        mask, _ = _culled(b1, b2)
        rows, cols = np.nonzero(mask.numpy())
        keep = np.random.default_rng(8).permutation(len(rows))[:800]
        pairs1.append(b1[rows[keep]])
        pairs2.append(b2[cols[keep]])
    p1, p2 = np.concatenate(pairs1), np.concatenate(pairs2)
    assert len(p1) > 2000
    got = np.asarray(jax_fused([jnp.asarray(p1[:, c]) for c in range(d)],
                               [jnp.asarray(p2[:, c]) for c in range(d)]))
    assert np.isfinite(got).all()
    assert float(np.abs(got).max()) <= 1e-4


@pytest.mark.parametrize("d", [4, 5])
def test_the_cull_takes_most_disjoint_pairs(d):
    """Not vacuous: on uniform boxes the cull takes over half of the pairs
    and most of those whose IoU is 0.0; along the meridian it takes pairs
    placed 1 % beyond the margin, and fewer of those 1 % within it."""
    mask, iou = _culled(*_uniform(d))
    share = float(mask.float().mean())
    assert 0.5 < share < 0.7
    assert share > 0.6 * float((iou == 0.0).float().mean())
    b1, b2 = _meridian(d)
    matched = sph2pob_disjoint_plain(torch.from_numpy(b1),
                                     torch.from_numpy(b2)).numpy()
    beyond, within = matched[0::2], matched[1::2]
    assert beyond.mean() > 0.5
    assert within.mean() < beyond.mean()


def test_identical_and_touching_pairs_are_never_culled():
    b = torch.from_numpy(generate_boxes(50, 5, seed=9))
    assert not bool(sph2pob_disjoint_plain(b, b.clone()).any())
    cells = torch.tensor([[t, p, 30.0, 30.0]
                          for t in np.arange(30.0, 180.0, 30.0)
                          for p in np.arange(45.0, 135.0, 30.0)])
    mask = sph2pob_disjoint_plain(cells[:, None], cells[None])
    dist = torch.cdist(cells[:, :2], cells[:, :2])
    assert not bool(mask[dist <= 30.0 + 1e-3].any())


def test_disjoint_rejects_what_the_kernels_do_not_take():
    b = torch.zeros((3, 4))
    with pytest.raises(ValueError):
        sph2pob_disjoint_plain(b, torch.zeros((3, 5)))
    with pytest.raises(ValueError):
        sph2pob_disjoint_plain(torch.zeros((3, 3)), torch.zeros((3, 3)))


def test_kernel_header_cull_constants_match_the_plain_version():
    path = os.path.join(os.path.dirname(tf.__file__), "..", "csrc",
                        "sph2pob_pair.cuh")
    with open(path) as f:
        src = f.read()
    m = re.search(r"constexpr double kCullMarginD = ([0-9.eE+-]+);", src)
    assert m and float(m.group(1)) == tf._CULL_MARGIN
    assert tf._CULL_MARGIN >= 1e-3
    assert "constexpr float kCosLb6 = (float)(-1.0 / 720.0);" in src
    assert "constexpr float kCosLb4 = (float)(1.0 / 24.0);" in src
    assert "kHalfCullMargin = (float)(kCullMarginD / 2.0);" in src

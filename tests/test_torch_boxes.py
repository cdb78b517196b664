"""Anchors, coder, formator and NMS of the PyTorch port vs the JAX package.

Inputs are made with numpy from a seed and handed to both sides. Tolerances:
anchors exact (both sides run the same numpy on the host); coder decode and
formator 1e-6 relative (closed-form fp32, exp/log of each library), stated
per test; NMS compares the kept sets exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.boxes import nms as jnms
from sph_retina_tpu.boxes.anchors import SphAnchorGenerator as JaxAnchors
from sph_retina_tpu.boxes.coders import SphBBoxCoder as JaxCoder
from sph_retina_tpu.boxes.formator import sph2planar_boxes as jax_sph2planar
from sph_retina_tpu.geometry import generate_boxes
from sph_retina_tpu.iou.api import canonical_backend as jax_canonical
from sph_retina_tpu_torch.boxes import nms as tnms
from sph_retina_tpu_torch.boxes.anchors import SphAnchorGenerator
from sph_retina_tpu_torch.boxes.coders import SphBBoxCoder
from sph_retina_tpu_torch.boxes.formator import sph2planar_boxes
from sph_retina_tpu_torch.iou.api import _ALIASES, canonical_backend

ANCHOR_KW = dict(strides=[8, 16, 32, 64, 128], ratios=[0.5, 1.0, 2.0],
                 octave_base_scale=4, scales_per_octave=3)


def _featmaps(h, w, strides):
    return [(-(-h // s), -(-w // s)) for s in strides]


@pytest.mark.parametrize("version", [4, 5])
def test_anchors_equal_and_count_at_full_size(version):
    fs = _featmaps(512, 1024, ANCHOR_KW["strides"])
    ref = JaxAnchors(box_version=version, **ANCHOR_KW).grid_anchors(fs)
    gen = SphAnchorGenerator(box_version=version, **ANCHOR_KW)
    got = gen.grid_anchors(fs)
    assert len(got) == 5 and gen.num_base_anchors == 9
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    flat = gen.flat_anchors(fs)
    assert tuple(flat.shape) == (98208, version)


@pytest.mark.parametrize("version", [4, 5])
def test_coder_decode_and_encode(version):
    rng = np.random.default_rng(version)
    anchors = generate_boxes(300, version, seed=5, fov_range=(2.0, 80.0))
    deltas = rng.normal(0, 0.6, (300, version)).astype(np.float32)
    deltas[:10] *= 20.0  # reach the dw/dh and border clamps
    means = [0.01 * i for i in range(version)]
    stds = [1.0, 0.5, 0.2, 0.2, 0.1][:version]
    jc = JaxCoder(box_version=version, target_means=means, target_stds=stds)
    tc = SphBBoxCoder(box_version=version, target_means=means,
                      target_stds=stds)

    ref = np.asarray(jc.decode(jnp.asarray(anchors), jnp.asarray(deltas)))
    got = tc.decode(torch.from_numpy(anchors), torch.from_numpy(deltas)).numpy()
    # 1e-6 relative: one fp32 rounding of each library's exp
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    lo, hi = tc.clip_bounds()
    assert (got >= lo.numpy()).all() and (got <= hi.numpy()).all()

    gt = generate_boxes(300, version, seed=6, fov_range=(2.0, 80.0))
    ref = np.asarray(jc.encode(jnp.asarray(anchors), jnp.asarray(gt)))
    got = tc.encode(torch.from_numpy(anchors), torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("version", [4, 5])
@pytest.mark.parametrize("img_size", [(512, 1024), (64, 128)])
def test_sph2planar_boxes(version, img_size):
    b = generate_boxes(50, version, seed=2, fov_range=(1.0, 100.0))
    ref = np.asarray(jax_sph2planar(jnp.asarray(b), img_size=img_size))
    got = sph2planar_boxes(torch.from_numpy(b), img_size).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_backend_aliases_are_the_jax_table():
    for name in list(_ALIASES) + ["sph2pob_efficient", "planar", "nonsense"]:
        assert canonical_backend(name) == jax_canonical(name)


def _greedy_loop(iou, valid, thr):
    """The textbook sequential greedy NMS over a score-sorted set."""
    keep = np.zeros(len(valid), bool)
    for i in range(len(valid)):
        if valid[i] and not np.any(keep[:i] & (iou[:i, i] > thr)):
            keep[i] = True
    return keep


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_suppress_equals_fixpoint_form_and_loop(seed):
    rng = np.random.default_rng(seed)
    k = 120
    iou = rng.uniform(0, 1, (k, k)).astype(np.float32) ** 3
    iou = np.maximum(iou, iou.T)
    valid = rng.uniform(size=k) > 0.1
    ref = np.asarray(jnms._greedy_suppress(jnp.asarray(iou),
                                           jnp.asarray(valid), 0.5))
    got = tnms._greedy_suppress(torch.from_numpy(iou),
                                torch.from_numpy(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _greedy_loop(iou, valid, 0.5))


def _clustered_boxes(version, seed, n=400):
    """Seeded boxes in clusters, so that NMS has something to suppress."""
    rng = np.random.default_rng(seed)
    centres = generate_boxes(40, version, seed=seed, fov_range=(10.0, 60.0),
                             phi_range=(30.0, 150.0))
    boxes = centres[rng.integers(0, 40, n)] + rng.normal(
        0, 1.5, (n, version)).astype(np.float32)
    boxes[:, 2:4] = np.clip(boxes[:, 2:4], 2.0, 170.0)
    scores = rng.uniform(0.06, 1.0, n).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.1
    return boxes.astype(np.float32), scores, labels, valid


@pytest.mark.parametrize("version,backend", [
    (4, "sph2pob_efficient"), (5, "sph2pob_efficient"),
    (5, "sph2pob_efficient_iou"), (4, "planar")])
def test_batched_nms_keeps_the_same_set(version, backend):
    boxes, scores, labels, valid = _clustered_boxes(version, seed=3)
    kw = dict(iou_threshold=0.5, max_num=60, nms_pre=300, backend=backend)
    ref = jnms.sph_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(labels),
                               valid_mask=jnp.asarray(valid), **kw)
    got = tnms.sph_batched_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               torch.from_numpy(labels),
                               valid_mask=torch.from_numpy(valid), **kw)
    rv, gv = np.asarray(ref.valid), got.valid.numpy()
    np.testing.assert_array_equal(gv, rv)
    assert 10 < rv.sum() <= 60  # something was kept, something suppressed
    np.testing.assert_array_equal(got.inds.numpy()[gv],
                                  np.asarray(ref.inds)[rv])
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert got.labels.dtype == torch.int32
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_array_equal(got.boxes.numpy()[gv],
                                  np.asarray(ref.boxes)[rv])
    assert tuple(got.boxes.shape) == (60, version)


def test_nms_names_the_backend_it_lacks():
    boxes, scores, labels, _ = _clustered_boxes(4, seed=4, n=20)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(labels))
    kept = tnms.sph_batched_nms(*args, backend="kent_iou", max_num=20)
    assert 0 < int(kept.valid.sum()) <= 20
    boxes5 = torch.from_numpy(_clustered_boxes(5, seed=4, n=20)[0])
    with pytest.raises(ValueError, match="unknown IoU backend 'nonsense'"):
        tnms.sph_batched_nms(boxes5, args[1], args[2], backend="nonsense")

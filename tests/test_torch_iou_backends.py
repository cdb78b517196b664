"""The IoU backends of the PyTorch port vs the JAX package, on the CPU.

``sph_overlaps`` for the seven backends the port has (``sph2pob_standard``,
``sph2pob_efficient``, ``sph2pob_legacy``, ``unbiased``, ``sph``, ``fov``,
``naive``), aligned and pairwise, 4- and 5-dof; the NMS with the ``naive``,
``unbiased`` and 5-dof ``planar`` backends; the IoU tool's ``--backends``
rows. The same numpy inputs, made from a seed, go through both packages. The
JAX side runs eagerly (compiling all seven backends takes ~20 s on the CPU,
running them eagerly ~12 s), each backend once a box width, on the aligned
pairs and the pairwise pairs flattened together: that is what its
``sph_overlaps`` does for ``is_aligned=False`` (broadcast, then the aligned
code), as one test checks. Tolerances:

- IoU values: 1e-4 (the JAX suite's own) on seeded pairs;
- bitwise-identical pairs sit on the jitter thresholds, where the unbiased
  oracle differs between the JAX package's own eager and jitted runs by up to
  2e-3: there the IoU is > 0.95 in every backend (the invariant of
  ``tests/test_rotated_iou.py``) and the gradient finite;
- NMS: the kept sets are equal.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.boxes import nms as jnms
from sph_retina_tpu.iou import api as japi
from sph_retina_tpu_torch import benchmark_iou
from sph_retina_tpu_torch.boxes import nms as tnms
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.iou import api as tapi

from test_torch_boxes import _clustered_boxes

TOL = 1e-4
BACKENDS = ("sph2pob_standard", "sph2pob_efficient", "sph2pob_legacy",
            "unbiased", "sph", "fov", "naive")
N, ROWS, COLS = 48, 6, 8  # aligned pairs; pairwise (ROWS, COLS)


def _inputs(d):
    b1 = generate_boxes(N, d, seed=10 + d)
    b2 = generate_boxes(N, d, seed=20 + d)
    return b1, b2, b1[:ROWS], b2[N - COLS:]


@pytest.fixture(scope="module")
def jax_overlaps():
    """{(backend, d): (aligned (N,), pairwise (ROWS, COLS))} from the JAX
    package, one call a backend and box width."""
    out = {}
    for d in (4, 5):
        a1, a2, p1, p2 = _inputs(d)
        f1 = np.broadcast_to(p1[:, None], (ROWS, COLS, d)).reshape(-1, d)
        f2 = np.broadcast_to(p2[None], (ROWS, COLS, d)).reshape(-1, d)
        x = jnp.asarray(np.concatenate([a1, f1]))
        y = jnp.asarray(np.concatenate([a2, f2]))
        for b in BACKENDS:
            row = np.asarray(japi.sph_overlaps(x, y, b, is_aligned=True))
            out[b, d] = row[:N], row[N:].reshape(ROWS, COLS)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("d", [4, 5])
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "pairwise"])
def test_sph_overlaps_equals_the_jax_packages(jax_overlaps, backend, d,
                                              aligned):
    a1, a2, p1, p2 = _inputs(d)
    x, y = (a1, a2) if aligned else (p1, p2)
    got = tapi.sph_overlaps(torch.from_numpy(x), torch.from_numpy(y),
                            backend, is_aligned=aligned)
    want = jax_overlaps[backend, d][0 if aligned else 1]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    if aligned:
        assert float(got.max()) > 0.05  # something overlaps


def test_jax_pairwise_is_the_aligned_code_on_broadcast_pairs(jax_overlaps):
    """The premise of the fixture, checked on the chart backends."""
    _, _, p1, p2 = _inputs(4)
    for b in ("sph", "naive"):
        direct = japi.sph_overlaps(jnp.asarray(p1), jnp.asarray(p2), b)
        np.testing.assert_allclose(np.asarray(direct), jax_overlaps[b, 4][1],
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", [4, 5])
def test_identical_boxes_give_one_and_finite_gradients(d):
    boxes = generate_boxes(8, d, seed=7)
    for backend in BACKENDS:
        a = torch.from_numpy(boxes).requires_grad_(True)
        b = torch.from_numpy(boxes.copy()).requires_grad_(True)
        iou = tapi.sph_overlaps(a, b, backend, is_aligned=True)
        assert float(iou.min()) > 0.95, backend
        (1.0 - iou).sum().backward()
        assert torch.isfinite(a.grad).all() and torch.isfinite(b.grad).all()


def test_public_wrappers_aliases_and_refusals():
    b1, b2 = (torch.from_numpy(b) for b in _inputs(4)[2:])
    for name in BACKENDS:
        fn = getattr(tapi, f"{name}_iou")
        torch.testing.assert_close(fn(b1, b2),
                                   tapi.sph_overlaps(b1, b2, name))
        torch.testing.assert_close(
            tapi.sph_overlaps(b1, b2, f"{name}_iou"),
            tapi.sph_overlaps(b1, b2, name))
    assert set(tapi.AVAILABLE_BACKENDS) == set(BACKENDS) | {"kent"}
    assert tapi.BACKENDS == japi.BACKENDS
    torch.testing.assert_close(tapi.kent_iou(b1, b2),
                               tapi.sph_overlaps(b1, b2, "kent_iou"))
    with pytest.raises(ValueError, match="unknown IoU backend"):
        tapi.sph_overlaps(b1, b2, "nonsense")
    assert tuple(tapi.sph_overlaps(torch.zeros((0, 4)), b2).shape) == (0, 8)


@pytest.mark.parametrize("version, backend", [
    (4, "naive_iou"), (5, "unbiased_iou"), (5, "planar")])
def test_batched_nms_keeps_the_same_set(version, backend):
    boxes, scores, labels, valid = _clustered_boxes(version, seed=5, n=160)
    kw = dict(iou_threshold=0.5, max_num=40, nms_pre=120, backend=backend)
    ref = jnms.sph_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(labels),
                               valid_mask=jnp.asarray(valid), **kw)
    got = tnms.sph_batched_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               torch.from_numpy(labels),
                               valid_mask=torch.from_numpy(valid), **kw)
    rv, gv = np.asarray(ref.valid), got.valid.numpy()
    np.testing.assert_array_equal(gv, rv)
    assert 5 < rv.sum() < 120  # something was kept, something suppressed
    np.testing.assert_array_equal(got.inds.numpy()[gv],
                                  np.asarray(ref.inds)[rv])
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))


def test_planar_nms_of_rotated_boxes_uses_the_rotated_iou():
    boxes = torch.from_numpy(_clustered_boxes(5, seed=6, n=30)[0])
    got = tnms._pairwise_iou(boxes, "planar")
    want = jnms._pairwise_iou(jnp.asarray(boxes.numpy()), "planar")
    assert tuple(got.shape) == (30, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(got.diagonal().numpy(), 1.0, atol=TOL)


def test_iou_tool_prints_the_backend_rows_with_their_errors(capsys):
    names = ["sph2pob_efficient", "sph_iou", "naive", "unbiased"]
    assert benchmark_iou.main(["--device", "cpu", "--size", "300",
                               "--box-version", "5", "--iters", "1",
                               "--backends", *names]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = {r["backend"]: r for r in map(json.loads, lines[1:])}
    assert list(rows) == ["fused_plain", "sph2pob_efficient", "sph", "naive",
                          "unbiased"]
    b1 = torch.from_numpy(generate_boxes(300, 5, seed=0))
    b2 = torch.from_numpy(generate_boxes(300, 5, seed=1))
    gold = tapi.sph_overlaps(b1, b2, "unbiased", True).double().numpy()
    for name, row in rows.items():
        assert {"time_s", "mpairs_per_s", "mean_err", "median_err",
                "max_err", "pearson_r", "max_abs_diff"} <= set(row)
        assert row["time_s"] > 0 and row["device"] == "cpu"
        vals = (tapi.sph_overlaps(b1, b2, name, True) if name != "fused_plain"
                else tapi.sph_overlaps(b1, b2, "sph2pob_efficient", True))
        err = np.abs(vals.double().numpy() - gold)
        assert row["max_err"] == pytest.approx(err.max(), abs=TOL)
        assert row["mean_err"] == pytest.approx(err.mean(), abs=TOL)
    assert rows["unbiased"]["max_err"] == 0.0
    assert rows["unbiased"]["pearson_r"] == pytest.approx(1.0)
    # the Sph2Pob IoU follows the oracle closely, the chart IoUs less so
    assert rows["sph2pob_efficient"]["pearson_r"] > 0.99
    assert rows["sph2pob_efficient"]["mean_err"] < rows["naive"]["mean_err"]
    with pytest.raises(ValueError, match="unknown IoU backend"):
        benchmark_iou.main(["--device", "cpu", "--size", "10",
                            "--backends", "kents"])

"""The aligned Sph2Pob IoU of the PyTorch port vs the JAX package, on the CPU.

On the CPU ``sph2pob_iou_aligned`` takes its plain version (the CUDA kernel
has no interpret mode; ``chip_smoke.py`` holds the kernel against the same
plain version on the card). The JAX side is the Pallas aligned kernel in
interpret mode with ``block_rows=1``, as ``tests/test_pallas_iou.py`` runs it.
Tolerances:

- 1e-4 against the Pallas kernel (the tolerance the JAX suite holds that
  kernel to against its own jnp path), on generic pairs;
- 1e-6 against the diagonal of the port's pairwise function (the same
  arithmetic on broadcast shapes);
- bitwise-identical and grid-adjacent boxes sit on the jitter thresholds,
  where the JAX package's own eager and jitted runs differ beyond 1e-4: for
  those the invariants of ``tests/test_rotated_iou.py`` are asserted (range,
  identical ~1, touching ~0).
"""

import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.geometry import generate_boxes as jax_generate_boxes
from sph_retina_tpu.ops import sph2pob_iou_aligned_tpu
from sph_retina_tpu_torch import benchmark_iou
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.ops import (
    sph2pob_iou_aligned,
    sph2pob_iou_aligned_plain,
    sph2pob_iou_pairwise,
)


@pytest.mark.parametrize("version", [4, 5])
@pytest.mark.parametrize("n", [1, 130, 1000])
def test_aligned_matches_the_pallas_kernel_in_interpret_mode(version, n):
    b1 = generate_boxes(n, version, seed=1)
    b2 = generate_boxes(n, version, seed=2)
    ref = np.asarray(sph2pob_iou_aligned_tpu(
        jnp.asarray(b1), jnp.asarray(b2), block_rows=1))
    launches = sph2pob_iou_aligned.launches
    got = sph2pob_iou_aligned(torch.from_numpy(b1), torch.from_numpy(b2))
    assert sph2pob_iou_aligned.launches == launches  # CPU: plain version
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


@pytest.mark.parametrize("version", [4, 5])
def test_aligned_equals_the_diagonal_of_pairwise(version):
    b1 = torch.from_numpy(generate_boxes(130, version, seed=3))
    b2 = torch.from_numpy(generate_boxes(130, version, seed=4))
    got = sph2pob_iou_aligned(b1, b2)
    want = sph2pob_iou_pairwise(b1, b2).diagonal()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        got.numpy(), sph2pob_iou_aligned_plain(b1, b2).numpy())


def test_degenerate_pairs_keep_the_invariants():
    rng = np.random.default_rng(11)
    n = 256
    base = torch.from_numpy(np.stack([
        rng.uniform(5, 355, n), rng.uniform(5, 175, n),
        rng.uniform(5, 90, n), rng.uniform(5, 90, n),
    ], -1).astype(np.float32))
    # bitwise-identical pairs
    ident = sph2pob_iou_aligned(base, base.clone())
    assert bool((ident >= 0.0).all()) and bool((ident <= 1.0).all())
    assert bool((ident > 0.95).all())
    # grid-adjacent boxes sharing one exact boundary meridian
    a = torch.tensor([[80.0, 90.0, 20.0, 20.0]])
    b = torch.tensor([[100.0, 90.0, 20.0, 20.0]])
    assert 0.0 <= float(sph2pob_iou_aligned(a, b)[0]) < 0.05
    # a grid of touching cells, every cell against every other
    cells = np.array([[t, p, 30.0, 30.0]
                      for t, p in itertools.product(
                          np.arange(30.0, 180.0, 30.0),
                          np.arange(45.0, 135.0, 30.0))], np.float32)
    i, j = np.meshgrid(np.arange(len(cells)), np.arange(len(cells)),
                       indexing="ij")
    got = sph2pob_iou_aligned(
        torch.from_numpy(cells[i.ravel()]), torch.from_numpy(cells[j.ravel()])
    ).reshape(len(cells), len(cells))
    assert bool(torch.isfinite(got).all())
    assert bool((got >= 0.0).all()) and bool((got <= 1.0).all())
    assert bool((got.diagonal() > 0.95).all())


def test_empty_input_and_no_gradient():
    empty = torch.zeros((0, 5))
    out = sph2pob_iou_aligned(empty, empty)
    assert out.shape == (0,) and out.dtype == torch.float32
    b1 = torch.from_numpy(generate_boxes(8, 4, seed=5)).requires_grad_(True)
    b2 = torch.from_numpy(generate_boxes(8, 4, seed=6))
    assert not sph2pob_iou_aligned(b1, b2).requires_grad


@pytest.mark.parametrize("bad, error", [
    (lambda b: (b.double(), b.double()), TypeError),
    (lambda b: (b.numpy(), b), TypeError),
    (lambda b: (b[:, :3].contiguous(), b[:, :3].contiguous()), ValueError),
    (lambda b: (b, b[:5]), ValueError),                       # N differs
    (lambda b: (b, torch.cat([b, b[:, :1]], 1)), ValueError),  # D differs
    (lambda b: (b.t().contiguous().t(), b), ValueError),      # strided
    (lambda b: (b[0], b[0]), ValueError),                     # 1-d
], ids=["float64", "numpy", "width3", "n_differs", "d_differs", "strided",
        "one_dim"])
def test_argument_checks_raise(bad, error):
    b = torch.from_numpy(generate_boxes(10, 4, seed=7))
    with pytest.raises(error):
        sph2pob_iou_aligned(*bad(b))


def test_generate_boxes_equals_the_jax_packages():
    for version, kwargs in ((4, {}), (5, {"fov_range": (10.0, 60.0)})):
        np.testing.assert_array_equal(
            generate_boxes(50, version, seed=9, **kwargs),
            jax_generate_boxes(50, version, seed=9, **kwargs))


def test_iou_tool_prints_its_rows_on_the_cpu(capsys):
    assert benchmark_iou.main(["--device", "cpu", "--size", "2000",
                               "--box-version", "5", "--iters", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# 2,000 random pairs, box_version=5")
    rows = [json.loads(line) for line in lines[1:]]
    assert [r["backend"] for r in rows] == ["fused_plain"]
    assert rows[0]["time_s"] > 0 and rows[0]["mpairs_per_s"] > 0
    assert rows[0]["device"] == "cpu" and rows[0]["max_abs_diff"] == 0.0


def test_iou_tool_refuses_what_it_cannot_run(capsys):
    # every backend of the package runs, kent included, by either spelling
    assert benchmark_iou.main(["--device", "cpu", "--size", "50", "--iters",
                               "1", "--backends", "kent_iou"]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()[1:]]
    assert [r["backend"] for r in rows] == ["fused_plain", "kent"]
    with pytest.raises(ValueError, match="unknown IoU backend"):
        benchmark_iou.main(["--device", "cpu", "--backends", "nonsense"])
    with pytest.raises(ValueError, match="--kernel"):
        benchmark_iou.main(["--device", "cpu", "--size", "2000", "--kernel"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            benchmark_iou.main(["--size", "2000"])

"""The anchor optimiser of the port against the JAX package's.

JAX's random streams (``jax.random.choice`` for k-means' first centres,
threefry keys for the whole DE population) cannot be reproduced in
PyTorch, so each deterministic step is held to the JAX package on the same
inputs, and the whole runs to the JAX tests' own properties:

- ``_kmeans_sweeps`` from JAX's own initial indices: the JAX
  ``kmeans_anchors``' centres within 1e-3 degree, the same assignments;
- ``_population_fitness``: JAX's ``mean_best_iou`` of each individual
  within 1e-4;
- one DE generation (``_de_generation``) from its draws: a numpy rand/1/bin
  reference written here, exactly; the draws' donors distinct and none the
  target;
- ``optimize_anchors.main --synthetic`` against ``tools/optimize_anchors.py``
  run in this process: the same 232 ground-truth boxes and the "before"
  score within 1e-4.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from sph_retina_tpu.boxes import anchor_opt as jopt
from sph_retina_tpu_torch import optimize_anchors as tool
from sph_retina_tpu_torch.boxes import anchor_opt as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs",
                      "sph_rotated_retinanet_r50_fpn_120e_pandora.py")
BACKEND = "sph2pob_efficient"


@pytest.fixture(scope="module")
def clustered_fovs():
    """Two tight FoV clusters, (20, 10)-ish and (60, 40)-ish (the JAX
    tests' set), and two identical FoVs."""
    rng = np.random.default_rng(0)
    a = rng.normal([20, 10], 1.0, (60, 2))
    b = rng.normal([60, 40], 1.5, (60, 2))
    fovs = np.clip(np.concatenate([a, b]), 2, 175).astype(np.float32)
    fovs[1] = fovs[0]
    return fovs


def test_centered_boxes_and_too_few_gt():
    fovs = np.array([[30.0, 20.0], [5.0, 170.0]], np.float32)
    got = topt.centered_boxes(torch.from_numpy(fovs))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jopt.centered_boxes(fovs)))
    np.testing.assert_array_equal(got.numpy()[0], [180.0, 90.0, 30.0, 20.0])
    with pytest.raises(ValueError, match="3 GT boxes < 5 anchors"):
        topt.kmeans_anchors(np.ones((3, 2), np.float32), 5, device="cpu")


@pytest.mark.parametrize("k", [9, 12])
def test_kmeans_sweeps_from_jax_initial_centres(clustered_fovs, k):
    n = clustered_fovs.shape[0]
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n, (k,),
                                        replace=False))
    gt = torch.from_numpy(clustered_fovs)
    got = topt._kmeans_sweeps(gt, gt[torch.from_numpy(init)], 25,
                              BACKEND).numpy()
    want = jopt.kmeans_anchors(clustered_fovs, k, iters=25, seed=0,
                               backend=BACKEND)
    got = got[np.argsort(got.prod(axis=1))]
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)

    mine = topt.sph_overlaps(topt.centered_boxes(gt),
                             topt.centered_boxes(torch.from_numpy(got)),
                             BACKEND).numpy().argmax(axis=1)
    theirs = np.asarray(jopt.sph_overlaps(
        jopt.centered_boxes(clustered_fovs), jopt.centered_boxes(want),
        BACKEND)).argmax(axis=1)
    np.testing.assert_array_equal(mine, theirs)
    # an empty cluster keeps its centre
    far = torch.tensor([[20.0, 10.0], [178.0, 178.0]])
    moved = topt._kmeans_sweeps(gt[:60], far, 3, BACKEND)
    np.testing.assert_array_equal(moved[1].numpy(), [178.0, 178.0])


def test_population_fitness_equals_jax_mean_best_iou(clustered_fovs):
    k, p = 3, 6
    pop = torch.rand(p, 2 * k, generator=torch.Generator().manual_seed(1))
    pop = 1.0 + 178.0 * pop
    pop[0, :2] = torch.from_numpy(clustered_fovs[0])  # an identical FoV
    got = topt._population_fitness(torch.from_numpy(clustered_fovs), pop, k,
                                   BACKEND).numpy()
    want = [jopt.mean_best_iou(clustered_fovs, ind.reshape(k, 2).numpy(),
                               BACKEND) for ind in pop]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for ind, w in zip(pop, want):
        assert abs(topt.mean_best_iou(clustered_fovs, ind.reshape(k, 2),
                                      BACKEND, device="cpu") - w) <= 1e-4


def test_one_generation_equals_a_numpy_reference(clustered_fovs):
    k, p, mutation, bounds = 3, 10, 0.5, (1.0, 179.0)
    gen = torch.Generator().manual_seed(3)
    gt = torch.from_numpy(clustered_fovs)
    pop = 1.0 + 178.0 * torch.rand(p, 2 * k, generator=gen)
    fit = topt._population_fitness(gt, pop, k, BACKEND)
    for _ in range(3):
        donors, cross, forced = topt._de_draws(gen, p, 2 * k, 0.9)
        d = donors.numpy()
        assert d.shape == (p, 3)
        assert all(len(set(row)) == 3 for row in d.tolist())
        assert not (d == np.arange(p)[:, None]).any()
        assert ((d >= 0) & (d < p)).all()
        new_pop, new_fit = topt._de_generation(
            gt, pop, fit, donors, cross, forced, mutation=mutation,
            bounds=bounds, num_anchors=k, backend=BACKEND)
        # the reference: rand/1/bin in numpy from the same draws
        x = pop.numpy()
        mutant = np.clip(x[d[:, 0]] + mutation * (x[d[:, 1]] - x[d[:, 2]]),
                         *bounds)
        forced_one = np.arange(2 * k)[None] == forced.numpy()[:, None]
        take = cross.numpy() | forced_one
        trial = np.where(take, mutant, x)
        tfit = topt._population_fitness(gt, torch.from_numpy(trial), k,
                                        BACKEND).numpy()
        better = tfit > fit.numpy()
        np.testing.assert_array_equal(new_pop.numpy(),
                                      np.where(better[:, None], trial, x))
        np.testing.assert_array_equal(new_fit.numpy(),
                                      np.where(better, tfit, fit.numpy()))
        assert (new_fit >= fit).all()
        pop, fit = new_pop, new_fit


def test_whole_runs_keep_the_jax_tests_properties(clustered_fovs):
    anchors = topt.kmeans_anchors(clustered_fovs, 2, iters=20, seed=0,
                                  device="cpu")
    assert anchors.shape == (2, 2)
    np.testing.assert_allclose(anchors[0], [20, 10], atol=2.5)
    np.testing.assert_allclose(anchors[1], [60, 40], atol=2.5)
    good = topt.mean_best_iou(clustered_fovs, anchors, device="cpu")
    bad = topt.mean_best_iou(clustered_fovs, np.array([[120.0, 120.0]]),
                             device="cpu")
    assert good > 0.85 > bad
    base = np.array([[90.0, 90.0], [45.0, 45.0]], np.float32)
    before = topt.mean_best_iou(clustered_fovs, base, device="cpu")
    evolved = topt.evolve_anchors(clustered_fovs, 2, iters=30, pop_size=16,
                                  seed=0, device="cpu")
    after = topt.mean_best_iou(clustered_fovs, evolved, device="cpu")
    assert after > before and after > 0.8
    assert (evolved >= 1.0).all() and (evolved <= 179.0).all()
    assert np.all(np.diff(evolved.prod(axis=1)) >= 0)  # sorted by area


def _said(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        fn()
    return out.getvalue()


def _jax_tool(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_tool_optimize_anchors",
        os.path.join(REPO, "tools", "optimize_anchors.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = ["optimize_anchors.py", *argv]
    try:
        return _said(mod.main)
    finally:
        sys.argv = saved


def _score(said, what):
    line = next(x for x in said.splitlines() if x.startswith(what))
    return float(line.rsplit("=", 1)[1])


def test_the_tool_against_the_jax_tool(tmp_path):
    mine_dir, theirs_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = [CONFIG, "--synthetic", "--algorithm", "k-means", "--iters", "3",
            "--device", "cpu"]
    mine = _said(lambda: tool.main(argv + ["--output-dir", mine_dir]))
    theirs = _jax_tool(argv + ["--output-dir", theirs_dir])
    assert "232 GT boxes from 64 images" in mine.splitlines()[0]
    assert mine.splitlines()[0] == theirs.splitlines()[0]
    assert "config anchors: K=45" in mine
    assert abs(_score(mine, "config anchors") - _score(theirs,
                                                       "config anchors")) \
        <= 1e-4
    paths = [os.path.join(d, "anchor_optimize_result.json")
             for d in (mine_dir, theirs_dir)]
    results = []
    for path in paths:
        with open(path) as f:
            results.append(json.load(f))
        os.remove(path)
    assert list(results[0]) == list(results[1])
    assert np.asarray(results[0]["anchors_alpha_beta_deg"]).shape == (45, 2)
    assert results[0]["avg_best_iou"] > _score(mine, "config anchors")
    said = _said(lambda: tool.main([
        CONFIG, "--synthetic", "--iters", "2", "--num-anchors", "5",
        "--device", "cpu"]))
    assert "optimized anchors (differential_evolution): K=5" in said
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main([CONFIG, "--synthetic"])

"""Drawing in the port against the JAX package's: the perspective camera,
the Kent visualisation, the analysis plots, the colormaps of
``visualize/canvas.py`` and ``apis.show_result``.

Tolerances: the camera's views within 1e-9 (float64 images) and 1 level
(uint8); its border points within 1e-9, ``draw_box`` bitwise; the Kent grid
bitwise, its density within 1e-12 relative, its samples bitwise, its frame
within 1e-6 of both JAX twins; R within 1e-12; ``show_result`` bitwise.
Figures are drawn by PIL, not matplotlib, so the pictures are not
compared: the numbers they are drawn from are, the colormap tables equal
matplotlib's, heat-map pixels are the table's colour of their normalised
value, and curve and scatter pixels land where the axes' map puts them.
"""

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu import apis as japis
from sph_retina_tpu.data import SphPipeline as JaxPipeline
from sph_retina_tpu.iou.kent import kent_angles_to_gammas as jax_gammas
from sph_retina_tpu.visualize import camera as jcamera
from sph_retina_tpu.visualize import kent_vis as jkent
from sph_retina_tpu.visualize import plots as jplots
from sph_retina_tpu_torch.apis import (
    inference_detector,
    init_detector,
    show_result,
)
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.visualize import (
    PerspectiveCamera,
    canvas,
    kent_vis,
    plot_curve,
    plot_iou_scatter,
    plots,
)

CPU = torch.device("cpu")
PARAMS = [[20.0, 5.0, 1.0, 0.3, 0.5], [800.0, 150.0, 2.1, -0.7, 1.3],
          [3.0, 1.0, 0.2, 0.1, 3.0]]
VIEWS = [(10.0, 90.0), (355.0, 30.0), (180.0, 2.0), (90.0, 178.0),
         (0.0, 60.0)]
BOXES = [[355.0, 60.0, 40.0, 30.0], [2.0, 100.0, 50.0, 20.0, 25.0],
         [180.0, 90.0, 20.0, 20.0], [120.0, 10.0, 60.0, 40.0, -30.0]]


def _no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


# ------------------------------------------------------------------- camera
@pytest.mark.parametrize("fovs", [(64.0, 64.0), (80.0, 50.0), (40.0, 70.0)])
def test_camera_extract_equals_the_jax_packages(fovs):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (96, 192, 3), dtype=np.uint8)
    gray = rng.random((96, 192))
    mine = PerspectiveCamera(192, 96, *fovs, long_side=48, device="cpu")
    theirs = jcamera.PerspectiveCamera(192, 96, *fovs, long_side=48)
    assert (mine.img_w, mine.img_h) == (theirs.img_w, theirs.img_h)
    for theta, phi in VIEWS:
        got, want = mine.extract(rgb, theta, phi), theirs.extract(rgb,
                                                                  theta, phi)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1
        got, want = mine.extract(gray, theta, phi), theirs.extract(gray,
                                                                   theta, phi)
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
        as_tensor = mine.extract(torch.from_numpy(rgb), theta, phi)
        assert isinstance(as_tensor, torch.Tensor)
        np.testing.assert_array_equal(as_tensor.numpy(),
                                      mine.extract(rgb, theta, phi))
        np.testing.assert_allclose(
            mine.view_directions(theta, phi).numpy(),
            theirs.view_directions(theta, phi), atol=1e-12, rtol=0)


def test_camera_box_geometry_equals_the_jax_packages():
    image = np.random.default_rng(1).integers(0, 256, (96, 192, 3),
                                              dtype=np.uint8)
    mine = PerspectiveCamera(192, 96, device="cpu")
    theirs = jcamera.PerspectiveCamera(192, 96)
    for box in BOXES:
        np.testing.assert_allclose(mine.box_border_px(box, 32),
                                   theirs.box_border_px(box, 32),
                                   atol=1e-9, rtol=0)
        np.testing.assert_allclose(mine.planar_bbox(box),
                                   theirs.planar_bbox(box), atol=1e-9,
                                   rtol=0)
        got = mine.draw_box(image, box, color=(0, 255, 0), thickness=3)
        np.testing.assert_array_equal(
            got, theirs.draw_box(image, box, color=(0, 255, 0), thickness=3))
        assert not np.array_equal(got, image)
    # across the seam the wider of the two clusters is the box
    seam = mine.planar_bbox(BOXES[0])
    u = mine.box_border_px(BOXES[0])[:, 0]
    assert u.max() - u.min() > 96 and seam[2] - seam[0] < 96


# --------------------------------------------------------------------- kent
def test_kent_grid_density_samples_and_frame_equal_the_jax_packages():
    grid = kent_vis.erp_grid_directions((64, 128), device="cpu")
    assert grid.dtype == torch.float32
    np.testing.assert_array_equal(grid.numpy(),
                                  jkent.erp_grid_directions((64, 128)))
    for params in PARAMS:
        for normalize in (True, False):
            got = kent_vis.kent_density_erp(params, (64, 128), normalize,
                                            device="cpu")
            want = jkent.kent_density_erp(params, (64, 128), normalize)
            assert got.dtype == torch.float64 and got.shape == (64, 128)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-12 * want.max())
        samples = kent_vis.sample_kent(params, 300, seed=4, device="cpu")
        np.testing.assert_array_equal(samples.numpy(),
                                      jkent.sample_kent(params, 300, seed=4))
        theta, phi = kent_vis.directions_to_erp_deg(samples)
        want_theta, want_phi = jkent.directions_to_erp_deg(samples.numpy())
        np.testing.assert_allclose(theta.numpy(), want_theta, atol=1e-9,
                                   rtol=0)
        np.testing.assert_allclose(phi.numpy(), want_phi, atol=1e-9, rtol=0)
        angles = params[2:]
        frame = kent_vis.kent_angles_to_gammas(*angles, device="cpu")
        for twin in (jkent.kent_angles_to_gammas(*angles),
                     jax_gammas(*(jnp.float32(a) for a in angles))):
            for a, b in zip(frame, twin):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-6, rtol=0)
    # on the grid the normalised density integrates to ~1
    h, w = 64, 128
    dens = kent_vis.kent_density_erp(PARAMS[0], (h, w), device="cpu")
    phi = (np.arange(h) + 0.5) * np.pi / h
    d_omega = np.sin(phi)[:, None] * (2 * np.pi / w) * (np.pi / h)
    assert abs(float((dens.numpy() * d_omega).sum()) - 1.0) < 1e-12


def test_kent_heat_map_pixels_are_the_colormaps(monkeypatch, tmp_path):
    _no_matplotlib(monkeypatch)
    params, size = PARAMS[0], (48, 96)
    ax = kent_vis._kent_axes(params, size, 200, 3, None, None, CPU)
    plot = np.asarray(ax.plot)
    f = kent_vis.kent_density_erp(params, size, normalize=False,
                                  device="cpu").numpy()
    heat = canvas.INFERNO[canvas.colormap_index(
        (f - f.min()) / (f.max() - f.min()))]
    theta, phi = kent_vis.directions_to_erp_deg(
        kent_vis.sample_kent(params, 200, 3, device="cpu"))
    px, py = ax.to_px(theta.numpy(), phi.numpy())
    hit = np.zeros(size, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx * dx + dy * dy <= 1:
                r = np.clip(np.floor(py).astype(int) + dy, 0, size[0] - 1)
                c = np.clip(np.floor(px).astype(int) + dx, 0, size[1] - 1)
                hit[r, c] = True
    np.testing.assert_array_equal(plot[~hit], heat[~hit])
    # the samples' pixels lean towards cyan
    r, c = np.floor(py).astype(int), np.floor(px).astype(int)
    assert (plot[r, c, 0] <= heat[r, c, 0]).all()
    assert (plot[r, c, 1:] >= heat[r, c, 1:]).all()
    assert (plot[r, c] != heat[r, c]).any(axis=-1).all()
    out = str(tmp_path / "kent.png")
    fig = kent_vis.plot_kent_density(params, size, samples=200, seed=3,
                                     out_file=out, device="cpu")
    ax.render()
    x0, y0 = ax.origin
    np.testing.assert_array_equal(fig[y0:y0 + size[0], x0:x0 + size[1]],
                                  plot)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(out)), fig)
    background = np.random.default_rng(2).integers(0, 256, (96, 192, 3),
                                                   dtype=np.uint8)
    with_bg = kent_vis._kent_axes(params, size, 0, 0, background, "t", CPU)
    below = background[1::2, 1::2].astype(np.float64)  # nearest pixels
    want = np.round(0.55 * canvas.INFERNO[canvas.colormap_index(
        (f - f.min()) / (f.max() - f.min()))] + (1.0 - 0.55) * below)
    np.testing.assert_array_equal(np.asarray(with_bg.plot), want)
    os.remove(out)


def test_colormap_tables_are_matplotlibs():
    import matplotlib

    for name, table in canvas.COLORMAPS.items():
        want = matplotlib.colormaps[name](np.arange(256), bytes=True)[:, :3]
        np.testing.assert_array_equal(table, want)
        assert table.dtype == np.uint8 and table.shape == (256, 3)
    v = np.array([0.0, 0.5, 1.0, 1.2, -0.1, 255.5 / 256])
    np.testing.assert_array_equal(
        canvas.apply_colormap(v, "Blues", 0.0, 1.0),
        matplotlib.colormaps["Blues"](v, bytes=True)[:, :3])


# -------------------------------------------------------------------- plots
def test_iou_scatter_r_and_its_pixels(monkeypatch, tmp_path):
    rng = np.random.default_rng(5)
    a = rng.random(3000).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.08, a.shape), 0, 1).astype(np.float32)
    want = jplots.plot_iou_scatter(a, b)
    _no_matplotlib(monkeypatch)
    out = str(tmp_path / "scatter.png")
    r = plot_iou_scatter(a, b, out_file=out)
    assert isinstance(r, np.float64) and os.path.getsize(out) > 0
    assert abs(r - want) <= 1e-12
    assert plot_iou_scatter(torch.from_numpy(a), torch.from_numpy(b)) == r
    ax = plots._scatter_axes(a, b, "backend", "unbiased", r)
    plot = np.asarray(ax.plot)
    px, py = ax.to_px(b, a)
    far = np.abs(a - b) > 0.05  # away from the dashed diagonal
    pix = plot[np.floor(py[far]).astype(int), np.floor(px[far]).astype(int)]
    assert (pix != 255).any(axis=-1).all()          # every point is drawn
    assert (pix[:, 2] > pix[:, 0]).all()             # in the blue of C0
    blank = np.ones(plot.shape[:2], bool)
    blank[np.floor(py).astype(int), np.floor(px).astype(int)] = False
    assert (plot[blank] == 255).all(axis=-1).mean() > 0.5
    os.remove(out)


def test_curve_pixels_land_where_the_axes_put_them(monkeypatch, tmp_path):
    _no_matplotlib(monkeypatch)
    xs = np.arange(12.0)
    ys = {"loss": np.exp(-xs / 4), "loss_cls": 0.5 + 0.02 * xs}
    out = str(tmp_path / "curve.png")
    assert plot_curve(xs, ys, "step", "loss", out_file=out) is None
    assert os.path.getsize(out) > 0
    ax = plots._curve_axes(xs, ys, "step", "loss")
    plot = np.asarray(ax.plot)
    for i, (name, v) in enumerate(ys.items()):
        px, py = ax.to_px(xs, v)
        inside = (px < ax.width - 150) | (py > 60)  # clear of the legend
        pix = plot[np.floor(py[inside]).astype(int),
                   np.floor(px[inside]).astype(int)]
        if i == len(ys) - 1:  # the last curve is on top
            assert (pix == canvas.CYCLE[i]).all()
        assert (pix != 255).any(axis=-1).all()
    fig = ax.render()
    x0, y0 = ax.origin
    np.testing.assert_array_equal(fig[y0:y0 + ax.height,
                                      x0:x0 + ax.width][100:], plot[100:])
    os.remove(out)


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for fn in (lambda: PerspectiveCamera(64, 32),
               lambda: kent_vis.kent_density_erp(PARAMS[0], (8, 16)),
               lambda: kent_vis.sample_kent(PARAMS[0], 4),
               lambda: kent_vis.plot_kent_density(PARAMS[0], (8, 16))):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


# -------------------------------------------------------------- show_result
CFG = dict(model=dict(type="SphRetinaNet", num_classes=3, box_version=5,
                      backbone=dict(depth=18)),
           img_size=(64, 128), bf16=False)


def test_show_result_equals_the_jax_packages(tmp_path):
    det = init_detector(CFG, device="cpu")
    jdet = types.SimpleNamespace(
        pipeline=JaxPipeline(img_size=(64, 128), training=False),
        box_version=5)
    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, (96, 192, 3), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    from PIL import Image

    Image.fromarray(image).save(path)
    boxes = generate_boxes(9, 5, seed=7, fov_range=(10.0, 60.0))
    scores = rng.uniform(0.1, 1.0, 9).astype(np.float32)
    result = [np.concatenate([boxes[c::3], scores[c::3, None]], 1)
              for c in range(3)]
    empty = [np.zeros((0, 6), np.float32)] * 3
    for res, thr in ((result, 0.3), (result, 0.0), (empty, 0.3)):
        for img in (image, path, image.astype(np.float32)):
            got = show_result(det, img, res, score_thr=thr)
            want = japis.show_result(jdet, img, res, score_thr=thr)
            assert got.shape == (64, 128, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
    out = str(tmp_path / "shown.png")
    got = show_result(det, image, result, out_file=out)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), got)
    # the same on a real result of the detector
    res = inference_detector(det, image)
    np.testing.assert_array_equal(
        show_result(det, image, res, score_thr=0.0),
        japis.show_result(jdet, image, res, score_thr=0.0))
    os.remove(out)
    os.remove(path)

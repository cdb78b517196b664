"""The port's image operations and corruptions against OpenCV and the JAX
package, on the CPU.

- ``data/imgproc.py``: each function against the OpenCV call it stands in
  for (OpenCV imports where these tests run), on seeded inputs of
  64x128 and 37x75. Floats within 1e-5 on [0, 1] images; OpenCV's linear
  resize, ``remap`` and ``warpAffine`` on an image with ``BORDER_REFLECT``
  are bitwise (the interpolation step ``fma(p1 - p0, t, p0)`` and OpenCV's
  float32 warp positions; the warp on the columns of OpenCV's vector loop);
  the uint8 linear resize and the nearest resize
  are exact (share of differing values: 0).
- ``data/corruptions.py``: ``corrupt`` against the JAX package's for all
  15 corruptions at severities 1, 3 and 5 on 64x128 and at 3 on 37x75.
  Bitwise where the arithmetic is the JAX package's (the noises,
  ``brightness``, ``contrast`` with numpy's mean, ``jpeg_compression``
  through the same PIL, ``pixelate`` and ``zoom_blur`` through exact
  emulations of OpenCV's resizes); within one uint8 level, on fewer than
  1e-3 of the values, where a blur's or a warp's sums (exact or float32
  here, float32 in OpenCV, ~1e-7 apart) may cross a rounding boundary of
  ``_to_uint8``. At these inputs ``defocus_blur``, ``glass_blur``, ``fog``
  and ``elastic_transform`` come out bitwise too; ``motion_blur``,
  ``snow`` and ``frost`` differ by one level in at most 1 value of 1e4.
  Each case records its share of differing values (``record_property``).
- ``CorruptedDataset`` items equal the JAX package's, decoded from files
  and in memory; all 15 run with ``cv2`` made unimportable.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

from sph_retina_tpu.data import SphCocoDataset as JaxCocoDataset
from sph_retina_tpu.data import corruptions as jc
from sph_retina_tpu_torch.data import SphCocoDataset
from sph_retina_tpu_torch.data import corruptions as tc
from sph_retina_tpu_torch.data import imgproc
from utils.synthetic_coco import write_synthetic_coco

SIZES = [(64, 128), (37, 75)]
FLOAT_TOL = 1e-5
BITWISE = {"gaussian_noise", "shot_noise", "impulse_noise", "brightness",
           "jpeg_compression", "contrast", "pixelate", "zoom_blur"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _images(hw, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(hw + (3,)).astype(np.float32),
            rng.random(hw).astype(np.float32))


def _close(got, want, tol=FLOAT_TOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got - want).max())
    assert err <= tol, err
    return err


# ------------------------------------------------------------------ imgproc
@pytest.mark.parametrize("hw", SIZES, ids=str)
@pytest.mark.parametrize("k", [3, 7, 10, 13, 20, 25, 41])
def test_filter2d_equals_cv2(hw, k):
    """Odd and even kernels (the anchor at k // 2), kernels wider than the
    37-row image's one reflection, OpenCV's direct and DFT paths."""
    img, gray = _images(hw)
    kernel = np.random.default_rng(k).random((k, k)).astype(np.float32)
    kernel /= kernel.sum()
    for x in (img, gray):
        _close(imgproc.filter2d(_t(x), kernel).numpy(),
               cv2.filter2D(x, -1, kernel))


@pytest.mark.parametrize("hw", SIZES, ids=str)
@pytest.mark.parametrize("sigma", [0.7, 1.5, 2.96, 5.12, 9.0])
def test_gaussian_blur_equals_cv2(hw, sigma):
    """The glass blur's sigmas and the elastic field's ``sig * min(h,
    w)`` at these sizes; 9.0 gives 73 taps, past one reflection of 37
    rows. The kernel is OpenCV's bitwise."""
    img, gray = _images(hw)
    n = int(round(sigma * 8 + 1)) | 1
    np.testing.assert_array_equal(
        imgproc.gaussian_kernel(sigma).numpy(),
        cv2.getGaussianKernel(n, sigma, cv2.CV_32F)[:, 0])
    for x in (img, gray):
        _close(imgproc.gaussian_blur(_t(x), sigma).numpy(),
               cv2.GaussianBlur(x, (0, 0), sigma))


@pytest.mark.parametrize("hw", SIZES, ids=str)
@pytest.mark.parametrize("zoom", [1.02, 1.3, 2.0, 4.5, 0.6, 0.3])
def test_resize_linear_equals_cv2_bitwise(hw, zoom):
    img, gray = _images(hw)
    h, w = hw
    zh, zw = int(np.ceil(h * zoom)), int(np.ceil(w * zoom))
    for x in (img, gray):
        want = cv2.resize(x, (zw, zh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(
            imgproc.resize_linear(_t(x), (zh, zw)).numpy(), want)
        top, left = (zh - h) // 2 if zh > h else 0, \
            (zw - w) // 2 if zw > w else 0
        win = (top, left, min(h, zh), min(w, zw))
        np.testing.assert_array_equal(
            imgproc.resize_linear(_t(x), (zh, zw), window=win).numpy(),
            want[top:top + win[2], left:left + win[3]])


@pytest.mark.parametrize("hw", SIZES, ids=str)
@pytest.mark.parametrize("c", [0.6, 0.5, 0.4, 0.3, 0.25, 1.7])
def test_uint8_resizes_equal_cv2_exactly(hw, c, record_property):
    """``pixelate``'s two resizes; 1.7 also upscales through the uint8
    path, whose columns past the edge take the edge pixel alone."""
    h, w = hw
    img = np.random.default_rng(1).integers(0, 256, hw + (3,), np.uint8)
    size = (max(1, int(h * c)), max(1, int(w * c)))
    small = imgproc.resize_linear_u8(_t(img), size).numpy()
    want = cv2.resize(img, size[::-1], interpolation=cv2.INTER_LINEAR)
    record_property("differing_share", float((small != want).mean()))
    np.testing.assert_array_equal(small, want)
    np.testing.assert_array_equal(
        imgproc.resize_nearest(_t(want), hw).numpy(),
        cv2.resize(want, (w, h), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("grid", [(2, 2), (2, 4), (4, 8), (9, 18), (18, 37)],
                         ids=str)
@pytest.mark.parametrize("hw", SIZES, ids=str)
def test_resize_cubic_equals_cv2(grid, hw):
    """``_plasma``'s octave grids upsampled to the image."""
    g = np.random.default_rng(2).random(grid).astype(np.float32)
    _close(imgproc.resize_cubic(_t(g), hw).numpy(),
           cv2.resize(g, hw[::-1], interpolation=cv2.INTER_CUBIC))


@pytest.mark.parametrize("size", [10, 15, 20, 21, 25, 41])
def test_rotation_and_constant_border_warp_equal_cv2(size):
    """The motion kernels: a line rotated about the centre, 0 outside."""
    k = np.zeros((size, size), np.float32)
    k[size // 2, :] = 1.0
    for angle in (-44.3, 12.7, 90.0, 150.2):
        centre = (size / 2 - 0.5, size / 2 - 0.5)
        rot = cv2.getRotationMatrix2D(centre, angle, 1)
        mine = imgproc.rotation_matrix_2d(centre, angle, 1)
        _close(mine, rot, 1e-12)
        _close(imgproc.warp_affine(_t(k), mine, (size, size)).numpy(),
               cv2.warpAffine(k, rot, (size, size)))


@pytest.mark.parametrize("hw", SIZES, ids=str)
@pytest.mark.parametrize("ca", [0.02, 0.05, 0.3])
def test_affine_warp_with_reflect_border_equals_cv2(hw, ca):
    """``elastic_transform``'s affine: three jittered points, the warp with
    ``BORDER_REFLECT``; 0.3 reaches far past the edges."""
    img, _ = _images(hw)
    h, w = hw
    m = float(min(h, w))
    pts = np.float32([[w / 2, h / 2], [w / 2 + m / 4, h / 2],
                      [w / 2, h / 2 + m / 4]])
    jitter = np.random.default_rng(3).uniform(-ca * m, ca * m, (3, 2)) \
        .astype(np.float32)
    want_m = cv2.getAffineTransform(pts, pts + jitter)
    got_m = imgproc.affine_transform_3pt(pts, pts + jitter)
    _close(got_m, want_m, 1e-9)
    got = imgproc.warp_affine(_t(img), want_m, (w, h), border="reflect")
    want = cv2.warpAffine(img, want_m, (w, h), borderMode=cv2.BORDER_REFLECT)
    _close(got.numpy(), want)
    if w % 16 == 0:
        # OpenCV's vector loop covers every column (16 floats a vector on
        # an AVX-512 CPU); its scalar tail rounds the positions otherwise
        np.testing.assert_array_equal(got.numpy(), want)
    _close(imgproc.warp_affine(_t(img), got_m, (w, h),
                               border="reflect").numpy(), got.numpy())


@pytest.mark.parametrize("hw", SIZES, ids=str)
@pytest.mark.parametrize("amp", [0.015, 0.14, 3.0])
@pytest.mark.parametrize("border", ["reflect", "constant"])
def test_remap_equals_cv2_bitwise(hw, amp, border):
    """Displacements up to 3 x min(h, w): past more than one reflection."""
    img, _ = _images(hw)
    h, w = hw
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mx = xx + rng.uniform(-1, 1, (h, w)).astype(np.float32) * amp * min(h, w)
    my = yy + rng.uniform(-1, 1, (h, w)).astype(np.float32) * amp * min(h, w)
    mode = {"reflect": cv2.BORDER_REFLECT, "constant": cv2.BORDER_CONSTANT}
    np.testing.assert_array_equal(
        imgproc.remap(_t(img), _t(mx), _t(my), border).numpy(),
        cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=mode[border]))


def test_unknown_border_raises():
    with pytest.raises(ValueError, match="border"):
        imgproc.remap(torch.zeros(4, 4), torch.zeros(4, 4),
                      torch.zeros(4, 4), "wrap")


# -------------------------------------------------------------- corruptions
@pytest.fixture(scope="module")
def images():
    """The JAX suite's test image (noise, halved and lifted), at both
    sizes."""
    out = {}
    for hw in SIZES:
        base = np.random.default_rng(0).integers(0, 255, hw + (3,), np.uint8)
        out[hw] = (base // 2 + 64).astype(np.uint8)
    return out


CASES = [((64, 128), s) for s in (1, 3, 5)] + [((37, 75), 3)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}"
                         f"-s{c[1]}")
@pytest.mark.parametrize("name", tc.BENCHMARK_CORRUPTIONS)
def test_corrupt_equals_the_jax_packages(name, case, images,
                                         record_property):
    hw, severity = case
    img = images[hw]
    got = tc.corrupt(img, name, severity, seed=1)
    want = jc.corrupt(img, name, severity, seed=1)
    assert got.shape == want.shape == img.shape
    assert got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    record_property("differing_share", float((diff > 0).mean()))
    record_property("max_levels", int(diff.max()))
    if name in BITWISE:
        np.testing.assert_array_equal(got, want)
    else:
        assert diff.max() <= 1
        assert (diff > 0).mean() < 1e-3
    np.testing.assert_array_equal(tc.corrupt(img, name, severity, seed=1),
                                  got)  # the same bytes twice
    assert np.abs(got.astype(int) - img.astype(int)).mean() > 0.5


def test_corruption_tables_and_severity_zero(images):
    assert tc.BENCHMARK_CORRUPTIONS == jc.BENCHMARK_CORRUPTIONS
    assert len(tc.BENCHMARK_CORRUPTIONS) == 15
    img = images[(64, 128)]
    for name in ("gaussian_noise", "frost"):
        out = tc.corrupt(img, name, 0, seed=5)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, img)
    # another seed draws other noise; the JAX package's too
    for name in ("gaussian_noise", "motion_blur", "fog"):
        a, b = (tc.corrupt(img, name, 3, seed=s) for s in (1, 2))
        assert not np.array_equal(a, b)
        want = jc.corrupt(img, name, 3, seed=2).astype(int)
        assert np.abs(b.astype(int) - want).max() <= 1


def test_bad_inputs_raise_as_in_the_jax_package(images):
    img = images[(37, 75)]
    for args, exc in ((("nope", 1), KeyError), (("fog", 9), ValueError),
                      (("fog", -1), ValueError)):
        with pytest.raises(exc) as got:
            tc.corrupt(img, *args)
        with pytest.raises(exc) as want:
            jc.corrupt(img, *args)
        assert str(got.value) == str(want.value)


def _same_items(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("name", ["shot_noise", "elastic_transform"])
def test_corrupted_dataset_decodes_files_as_the_jax_package(name, tmp_path):
    ann, img_dir = write_synthetic_coco(str(tmp_path), n_images=3,
                                        img_size=(32, 64))
    kw = dict(ann_file=ann, img_prefix=img_dir + "/")
    got = tc.CorruptedDataset(SphCocoDataset(**kw), name, 2, seed=4)
    want = jc.CorruptedDataset(JaxCocoDataset(**kw), name, 2, seed=4)
    assert "image" not in SphCocoDataset(**kw)[0]  # the decode path
    _same_items(got, want)
    assert got.classes == want.classes  # attributes pass through
    assert not np.array_equal(got[0]["image"], got[1]["image"])


def test_corrupted_dataset_of_in_memory_items(images):
    class Items:
        classes = ("a",)

        def __len__(self):
            return 3

        def __getitem__(self, i):
            return {"image": np.roll(images[(37, 75)], i, axis=1),
                    "boxes": np.full((1, 4), 30.0, np.float32),
                    "labels": np.zeros(1, np.int32), "img_id": i}

    for name, sev in (("brightness", 2), ("pixelate", 4)):
        got = tc.CorruptedDataset(Items(), name, sev, seed=7)
        _same_items(got, jc.CorruptedDataset(Items(), name, sev, seed=7))
        assert len(got) == 3 and got.classes == ("a",)


def test_every_corruption_runs_without_cv2(images, monkeypatch):
    """``import cv2`` fails as on the card's host: the JAX package's blurs
    stop, the port's 15 corruptions do not."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = images[(37, 75)]
    with pytest.raises(ImportError):
        jc.corrupt(img, "defocus_blur", 1)
    for name in tc.BENCHMARK_CORRUPTIONS:
        out = tc.corrupt(img, name, 2, seed=3)
        assert out.shape == img.shape and out.dtype == np.uint8

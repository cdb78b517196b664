"""The port's input path against the JAX package's, on the CPU: the native
decoder (``csrc/sphloader.cpp``, built here with the host's C++ compiler),
the pipeline (``rgb`` fp32 / uint8 and packed-I420 ``yuv420``), the I420
conversion on the device, ``prefetch_to_device`` and the colorspace policy.

- the decoder's source is the JAX package's byte for byte; its library
  carries the CPU's fingerprint in its name, and ``status()`` says why it is
  unavailable where it cannot be built;
- decoded files: the identity on a same-size PNG, flips, a resized JPEG
  within the JAX test's bound (mean |d| < 0.05 normalised) of the JAX
  pipeline's PIL path; the batch functions zero and count the failed slots;
- with the pixels in the item (both pipelines take the PIL/numpy path):
  bitwise equal outputs, ``pack_yuv420`` bitwise, the same ``ValueError``s;
- ``maybe_normalize_images`` on seeded I420 batches within 1e-4 of the JAX
  function, edge rows and columns included; I420 against RGB after the
  conversion within the JAX test's JPEG bound (mean pixel error < 1.5,
  max < 16);
- ``prefetch_to_device``: order, errors raised after the batches before
  them, two batches ahead, no stream without a card, its thread gone when
  the consumer leaves;
- ``resolve_transfer_colorspace`` with injected probes: the JAX package's
  choice on a grid, 'rgb' with a warning when a probe raises.

The port's tests never call ``sph_retina_tpu.data.native_loader``, which
builds in ``native/``.
"""

import filecmp
import inspect
import os
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sph_retina_tpu.data.pipeline import SphPipeline as JaxPipeline
from sph_retina_tpu.data.policy import (
    resolve_transfer_colorspace as jax_resolve,
)
from sph_retina_tpu.engine.train import maybe_normalize_images as jax_normalize
from sph_retina_tpu_torch.data import native_loader as nl
from sph_retina_tpu_torch.data import policy
from sph_retina_tpu_torch.data.loader import prefetch_to_device, to_device
from sph_retina_tpu_torch.data.pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    SphPipeline,
    maybe_normalize_images,
)
from sph_retina_tpu_torch.ops import _build
from sph_retina_tpu_torch.utils.hostfp import cpu_feature_fingerprint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMPTY = {"boxes": np.zeros((0, 4), np.float32),
         "labels": np.zeros((0,), np.int32)}


@pytest.fixture(scope="module")
def native():
    """The decoder, built once a process (reused where a library of its
    name exists)."""
    if not nl.available():
        pytest.fail(f"the native decoder did not build: {nl.status()}")
    return nl


def _gradient(h, w):
    """Smooth gradients: 4:2:0 chroma subsampling and resampling are near
    exact on smooth content."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 2, yy * 3, xx + yy], -1).astype(np.uint8)


def test_decoder_source_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(
        os.path.join(REPO, "native", "sphloader.cpp"),
        os.path.join(REPO, "sph_retina_tpu_torch", "csrc", "sphloader.cpp"),
        shallow=False)


def test_native_decoder_is_the_identity_on_a_png_and_flips(native, tmp_path):
    """A same-size PNG decodes to its pixels, flipped on request; resized,
    the normalised uint8 path is within one quantum of the fused fp32 path;
    the pipeline takes the uint8 path for an item on disk and counts it."""
    img = np.random.default_rng(1).integers(0, 256, (64, 128, 3), np.uint8)
    p = str(tmp_path / "img.png")
    Image.fromarray(img).save(p)
    np.testing.assert_array_equal(native.load_image_u8(p, (64, 128)), img)
    np.testing.assert_array_equal(
        native.load_image_u8(p, (64, 128), flip=True), img[:, ::-1])
    u8 = native.load_image_u8(p, (32, 64)).astype(np.float32)
    f32 = native.load_image(p, (32, 64), IMAGENET_MEAN, IMAGENET_STD)
    np.testing.assert_allclose((u8 - IMAGENET_MEAN) / IMAGENET_STD, f32,
                               atol=0.5 / IMAGENET_STD.min())
    pipe = SphPipeline(img_size=(32, 64), max_gt=4, training=False,
                       normalize_on_device=True)
    before = native.status()["images"]
    out = pipe({"img_path": p, **EMPTY}, np.random.default_rng(0))
    assert native.status()["images"] == before + 1
    assert native.status()["calls"]["load_image_u8"] >= 1
    assert out["images"].dtype == np.uint8
    np.testing.assert_array_equal(out["images"], u8.astype(np.uint8))


def test_native_decoder_is_near_the_jax_pipelines_pil_path(native, tmp_path):
    """A resized JPEG: within the JAX test's bound of the JAX pipeline's
    PIL decode + resize + normalise (PIL's downscale averages an area, the
    decoder samples bilinearly: the same on smooth content); a batch with
    a flip flips."""
    p = str(tmp_path / "img.jpg")
    Image.fromarray(_gradient(64, 128)).save(p, quality=95)
    out = native.load_image(p, (32, 64), IMAGENET_MEAN, IMAGENET_STD)
    jpipe = JaxPipeline(img_size=(32, 64), training=False)
    ref = jpipe.normalize(jpipe.resize(jpipe.load_image(p)))
    assert out.shape == (32, 64, 3)
    assert np.abs(out - ref).mean() < 0.05
    batch, failed = native.load_batch([p, p], (32, 64), IMAGENET_MEAN,
                                      IMAGENET_STD, flips=[0, 1])
    assert failed == 0
    np.testing.assert_allclose(batch[1], batch[0][:, ::-1], atol=1e-6)


@pytest.mark.parametrize("kind", ["fp32", "u8", "yuv"])
def test_load_batch_reports_failures_and_zeroes_their_slots(native, tmp_path,
                                                            kind):
    p = str(tmp_path / "img.jpg")
    Image.fromarray(_gradient(64, 128)).save(p, quality=90)
    paths = [p, str(tmp_path / "missing.jpg"), p]
    if kind == "fp32":
        batch, failed = native.load_batch(paths, (32, 64), IMAGENET_MEAN,
                                          IMAGENET_STD, n_threads=2)
        one = native.load_image(p, (32, 64), IMAGENET_MEAN, IMAGENET_STD)
    elif kind == "u8":
        batch, failed = native.load_batch_u8(paths, (32, 64), n_threads=2)
        one = native.load_image_u8(p, (32, 64))
    else:
        batch, failed = native.load_batch_yuv(paths, (32, 64), n_threads=2)
        one = native.load_image_yuv(p, (32, 64))
        assert batch.shape == (3, 48, 64)
    assert failed == 1
    assert not batch[1].any()
    np.testing.assert_array_equal(batch[0], one)
    np.testing.assert_array_equal(batch[2], one)
    assert native.load_image_u8(paths[1], (32, 64)) is None


def test_a_library_built_for_another_cpu_is_not_loaded(native, tmp_path,
                                                       monkeypatch):
    """The library's name carries the CPU's fingerprint: in a directory
    that holds a binary built on another CPU, this host loads its own, and
    the other CPU would find only the one named for it."""
    mine = native.status()["library"]
    assert f"-{cpu_feature_fingerprint()}-" in os.path.basename(mine)
    cxx = _build.find_cxx()
    foreign = _build.host_library_path("sphloader", str(tmp_path),
                                       fingerprint="0123456789ab", cxx=cxx)
    with open(foreign, "wb") as f:
        f.write(b"\x7fELF built for another CPU")
    shutil.copy(mine, _build.host_library_path("sphloader", str(tmp_path),
                                               cxx=cxx))
    got = nl.open_library(str(tmp_path))
    assert got["lib"] is not None and got["build_seconds"] == 0.0
    assert got["library"] != foreign
    monkeypatch.setattr(_build, "cpu_feature_fingerprint",
                        lambda: "0123456789ab")
    other = nl.open_library(str(tmp_path))
    assert other["library"] == foreign and other["lib"] is None
    assert "cannot load" in other["reason"]


def test_status_says_why_the_decoder_cannot_be_built(tmp_path, monkeypatch):
    """A compiler that fails: no library, the compiler's command in the
    reason, nothing left in the build directory."""
    monkeypatch.setenv("CXX", shutil.which("false"))
    got = nl.open_library(str(tmp_path))
    assert got["lib"] is None and got["library"] is None
    assert "build failed" in got["reason"] and "sphloader.cpp" in got["reason"]
    assert os.listdir(tmp_path) == []


def test_native_decoder_off_decodes_with_pil(native, tmp_path):
    """``native_decoder=False`` (and an unavailable decoder alike) takes
    PIL: the JAX pipeline's output for the pixels PIL decodes."""
    p = str(tmp_path / "img.jpg")
    Image.fromarray(_gradient(64, 128)).save(p, quality=90)
    kw = dict(img_size=(32, 64), max_gt=4, training=False)
    before = native.status()["images"]
    got = SphPipeline(native_decoder=False, **kw)(
        {"img_path": p, **EMPTY}, np.random.default_rng(0))
    jpipe = JaxPipeline(**kw)
    want = jpipe({"image": jpipe.load_image(p), **EMPTY},
                 np.random.default_rng(0))
    np.testing.assert_array_equal(got["images"], want["images"])
    assert native.status()["images"] == before


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("d", [4, 5])
@pytest.mark.parametrize("mode", ["rgb_fp32", "rgb_u8", "yuv420"])
def test_pipeline_equals_the_jax_packages(mode, d, flip):
    """The pixels in the item: both pipelines resize with PIL and flip,
    normalise, keep uint8 or pack I420 alike; boxes flipped alike."""
    rng = np.random.default_rng(7)
    boxes = np.stack([rng.uniform(20, 340, 3), rng.uniform(40, 140, 3),
                      rng.uniform(15, 60, 3), rng.uniform(15, 60, 3),
                      rng.uniform(-40, 40, 3)], 1)[:, :d].astype(np.float32)
    item = {"image": rng.integers(0, 256, (40, 90, 3), np.uint8),
            "boxes": boxes, "labels": np.array([0, 2, 1], np.int32),
            "ignore_boxes": boxes[:1] + 1.0,
            "ignore_labels": np.array([1], np.int32), "img_id": 4}
    kw = dict(img_size=(32, 64), max_gt=5, box_version=d,
              flip_ratio=1.0 if flip else 0.0,
              normalize_on_device=mode != "rgb_fp32",
              transfer_colorspace="yuv420" if mode == "yuv420" else "rgb")
    got = SphPipeline(**kw)(dict(item), np.random.default_rng(3))
    want = JaxPipeline(**kw)(dict(item), np.random.default_rng(3))
    assert got.keys() == want.keys()
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if mode == "yuv420":
        assert got["images"].shape == (48, 64)


def test_pack_yuv420_and_the_checks_equal_the_jax_packages():
    rgb = np.random.default_rng(2).integers(0, 256, (32, 64, 3), np.uint8)
    got = SphPipeline(normalize_on_device=True).pack_yuv420(rgb)
    want = JaxPipeline(normalize_on_device=True).pack_yuv420(rgb)
    assert got.dtype == np.uint8 and got.shape == (48, 64)
    np.testing.assert_array_equal(got, want)
    for kw in ({"transfer_colorspace": "yuv420"},
               {"transfer_colorspace": "bgr"},
               {"transfer_colorspace": "auto", "normalize_on_device": True}):
        with pytest.raises(ValueError) as port_err:
            SphPipeline(**kw)
        with pytest.raises(ValueError) as jax_err:
            JaxPipeline(**kw)
        assert str(port_err.value) == str(jax_err.value).replace(
            "the jitted step", "the step")


@pytest.mark.parametrize("shape", [(2, 48, 64), (48, 64)])
def test_i420_conversion_equals_the_jax_function(shape):
    """Seeded random I420 (sharp chroma everywhere): within 1e-4
    normalised units of ``jax.image.resize``'s bilinear upsample and the
    same matrix, the first and last rows and columns included."""
    x = np.random.default_rng(11).integers(0, 256, shape, np.uint8)
    got = maybe_normalize_images(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_normalize(jnp.asarray(x)))
    h, w = shape[-2] * 2 // 3, shape[-1]
    assert got.shape == want.shape == (*shape[:-2], h, w, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for edge in (np.s_[..., 0, :, :], np.s_[..., -1, :, :],
                 np.s_[..., :, 0, :], np.s_[..., :, -1, :]):
        np.testing.assert_allclose(got[edge], want[edge], atol=1e-4, rtol=0)


def test_yuv420_transfer_close_to_rgb(native, tmp_path):
    """The JAX package's bound on the port's decoder: an I420 chart after
    the conversion is within JPEG noise of the RGB batch of the same file
    (mean pixel error < 1.5, max < 16); the host pack agrees as well; the
    decoder's flip flips all three planes alike."""
    p = str(tmp_path / "img.jpg")
    Image.fromarray(_gradient(64, 128)).save(p, quality=92)
    item = {"img_path": p, **EMPTY}
    kw = dict(img_size=(32, 64), max_gt=4, training=False,
              normalize_on_device=True)
    rgb_pipe = SphPipeline(**kw)
    rgb = rgb_pipe(dict(item), np.random.default_rng(0))["images"]
    yuv = SphPipeline(transfer_colorspace="yuv420", **kw)(
        dict(item), np.random.default_rng(0))["images"]
    assert yuv.shape == (48, 64) and yuv.dtype == np.uint8
    a = maybe_normalize_images(torch.from_numpy(rgb[None])).numpy()
    b = maybe_normalize_images(torch.from_numpy(yuv[None])).numpy()
    assert b.shape == (1, 32, 64, 3)
    pix_err = np.abs((a - b) * IMAGENET_STD)
    assert pix_err.mean() < 1.5 and pix_err.max() < 16.0
    c = maybe_normalize_images(torch.from_numpy(
        rgb_pipe.pack_yuv420(rgb)[None])).numpy()
    assert np.abs((a - c) * IMAGENET_STD).mean() < 1.5
    fl = native.load_image_yuv(p, (32, 64), flip=True)
    nf = native.load_image_yuv(p, (32, 64), flip=False)
    np.testing.assert_allclose(
        maybe_normalize_images(torch.from_numpy(fl)).numpy(),
        maybe_normalize_images(torch.from_numpy(nf)).numpy()[:, ::-1],
        atol=1e-5)


def test_prefetch_to_device_order_and_error():
    """In order; an exception of the transfer reaches the consumer after
    the batches before it (the JAX package's test)."""
    assert inspect.signature(prefetch_to_device).parameters[
        "depth"].default == 2
    out = list(prefetch_to_device(iter(range(7)), lambda x: x * 10, depth=2))
    assert out == [0, 10, 20, 30, 40, 50, 60]

    def boom(x):
        if x == 3:
            raise RuntimeError("decode failed")
        return x

    got = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for v in prefetch_to_device(iter(range(7)), boom, depth=2):
            got.append(v)
    assert got == [0, 1, 2]


def test_prefetch_runs_depth_ahead_and_its_thread_ends_early(monkeypatch):
    """Without a card no stream is created; the transfers run ``depth``
    batches ahead of a consumer that waits (one more waits to be queued);
    the thread ends once the consumer stops early."""
    def no_stream(*a, **k):
        raise AssertionError("a CUDA stream was created")

    monkeypatch.setattr(torch.cuda, "Stream", no_stream)
    calls = []

    def transfer(x):
        calls.append(x)
        return to_device({"x": np.full(2, x)}, "cpu")

    before = set(threading.enumerate())
    gen = prefetch_to_device(iter(range(50)), transfer, device="cpu")
    first = next(gen)
    assert first["x"].device.type == "cpu" and first["x"].tolist() == [0, 0]
    (thread,) = set(threading.enumerate()) - before
    time.sleep(0.3)
    assert len(calls) == 2 + 2  # one consumed, two queued, one waiting
    gen.close()
    thread.join(timeout=5)
    assert not thread.is_alive()
    assert list(prefetch_to_device(iter(range(3)), lambda x: x)) == [0, 1, 2]


HOSTS = [{"rgb": 244.0, "yuv420": 133.0}, {"rgb": 120.0, "yuv420": 310.0}]
LINKS = [3e6, 150e6, 25e9]


def _raises(*args):
    raise RuntimeError("no CUDA device to probe")


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("link", LINKS + [None])
@pytest.mark.parametrize("host", [0, 1, None])
def test_policy_choice_equals_the_jax_packages(host, link, workers):
    """The same model and argmax as the JAX package: on a grid of host
    rates and link bandwidths (``None``: that probe raises) both packages
    choose alike; the port warns where a probe failed and records what it
    measured."""
    probe_host = _raises if host is None else (lambda size: HOSTS[host])
    probe_link = _raises if link is None else (lambda: link)
    kw = dict(num_workers=workers, probe_host=probe_host,
              probe_link=probe_link)
    want = jax_resolve((512, 1024), **kw)
    if host is None or link is None:
        with pytest.warns(UserWarning, match="using 'rgb'"):
            got = policy.resolve_transfer_colorspace((512, 1024), **kw)
        assert "no CUDA device" in policy.resolve_transfer_colorspace \
            .last_probe["error"]
    else:
        got = policy.resolve_transfer_colorspace((512, 1024), **kw)
        record = policy.resolve_transfer_colorspace.last_probe
        assert record["link_bytes_per_sec"] == link
        assert record["host_images_per_sec"] == HOSTS[host]
    assert got == want
    assert policy.resolve_transfer_colorspace.last_probe["choice"] == got


def test_policy_probes_on_this_host(native):
    """The host probe decodes through the native decoder; the link probe
    needs a card and raises without one."""
    rates = policy._probe_host_rates((64, 128), n=2)
    assert set(rates) == {"rgb", "yuv420"} and min(rates.values()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            policy._probe_link_bytes_per_sec()


def test_collect_env_names_torch_and_the_decoders_compiler():
    from sph_retina_tpu_torch.utils.env import collect_env, env_string

    info = collect_env()
    assert info["torch"] == torch.__version__
    assert {"python", "cuda", "cudnn", "devices", "numpy"} <= set(info)
    assert info["native decoder compiler"].startswith(_build.find_cxx())
    assert "native decoder compiler: " in env_string(info)

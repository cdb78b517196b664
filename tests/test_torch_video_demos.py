"""The port's two video demos on the CPU against the JAX package's tools,
which run in this process (``tools/video_demo.py``, ``tools/webcam_demo.py``
with ``sys.argv`` set; no process is started).

An R18 64x128 5-dof detector over the suite's synthetic set; its weights go
across as one published ``.npz`` (the port's seeded initialisation in the Flax
layout, ``models/from_flax.py:to_flax``, written by the JAX package's
``save_published``, the class bias lowered so that a few boxes a frame are
drawn) that both ``init_detector``s load (the JAX side as its
``init_detector`` builds it from the file, less the random initialisation the
file replaces). The input is an 11-frame Motion-JPEG ``.avi`` that ``cv2``
writes. FFmpeg's Motion-JPEG decoder and PIL's differ
(``tests/test_torch_video.py``), so the JAX tools are handed the frames the
port decodes: ``cv2.VideoCapture`` of that file gives them, at the fps cv2
reads, and the container is held apart, in ``test_torch_video.py``. The JAX
tools' ``init_detector`` returns one detector of the module (exact top-k, one
jitted predict a batch shape).

- ``video_demo`` at ``--batch 4`` (a ragged last batch of 3, which the JAX
  tool pads and the port does not) and with ``--max-frames 6``: the printed
  lines, the output's frame count, size and fps equal (the JAX tool's
  ``mp4v`` read by cv2, the port's Motion JPEG by ``open_video``); each
  frame's detections, as each tool computed them, equal in labels and
  counts, scores within ``atol=1e-4`` and boxes within 5e-3 degrees (as
  ``test_torch_serve_slice.py``); each output frame within
  ``JPEG_TOLERANCE`` of ``show_result`` of that frame and detections, and
  bit for bit PIL's decode of PIL's JPEG of it;
- ``webcam_demo --source VIDEO --out DIR --max-frames 5``: the printed
  lines, the file names, the detections as above, the JPEGs (PIL's and
  ``cv2.imwrite``'s, quality 95) within ``TOOLS_TOLERANCE`` of each other;
- without ``--out`` and without a display the port exits before it builds a
  model; a wrong ``--out`` suffix exits by name before it too; without a
  card and without ``--device cpu`` both demos raise the port's CUDA error
  and write nothing.

Every file written is removed at the end (C12).
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import shutil
import sys

import cv2
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sph_retina_tpu import apis as japis
from sph_retina_tpu.engine.zoo import get_family as jax_get_family
from sph_retina_tpu.data import SphPipeline as JaxPipeline
from sph_retina_tpu.utils.config import load_config as jax_load_config
from sph_retina_tpu.utils.publish import load_published as jax_load_published
from sph_retina_tpu.utils.publish import save_published
from sph_retina_tpu_torch import apis as tapis
from sph_retina_tpu_torch import video_demo, webcam_demo
from sph_retina_tpu_torch.data import open_video
from sph_retina_tpu_torch.models.from_flax import to_flax
from sph_retina_tpu_torch.data.video import (
    UnsupportedVideo,
    decode_jpeg,
    encode_jpeg,
)
from utils.synthetic_coco import write_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 3
N_FRAMES = 11
BATCH = 4
MAX_FRAMES = 6
WEBCAM_FRAMES = 5
SCORE_ATOL = 1e-4  # the suite's default (ROADMAP "Tolerances")
# degrees: 1e-4 in the regression deltas times a large anchor's 50-degree
# field of view, as tests/test_torch_serve_slice.py holds the boxes (the
# two packages' fp32 networks put these boxes up to 5.5e-4 degrees apart)
BOX_ATOL = 5e-3
# A drawn frame against its JPEG at quality 95 (4:2:0): 64x128 frames of
# dark noise with 1-5 boxes' one-pixel outlines and labels drawn (measured
# on them: mean 2.47-7.82 levels, PSNR 24.29-32.90 dB). Held a frame: mean
# absolute difference and PSNR. The output frame is also held bit for bit
# to PIL's decode of PIL's JPEG of that frame.
JPEG_TOLERANCE = {"mean": 10.0, "psnr_db": 22.0}
# The two tools' JPEGs of one frame: each package draws its own detections
# (boxes up to BOX_ATOL apart move an outline's pixels) and encodes them
# (PIL's and OpenCV's libjpeg-turbo, quality 95); measured: equal with
# these weights, mean up to 1.44 levels and PSNR down to 28.55 dB with
# other weights.
TOOLS_TOLERANCE = {"mean": 3.0, "psnr_db": 25.0}
# the class bias (mean, sd): a few boxes a frame pass score_thr 0.3, so that
# the drawn frames are not covered by outlines
CLS_BIAS = (-2.75, 1.0)
# the NMS's candidates: the JAX package's (k, k) Sph2Pob IoU takes ~1 s a
# frame on the CPU at the config's 1 000
NMS_PRE = 200
CFG_TMPL = """\
model = dict(type="SphRetinaNet", num_classes={classes}, box_version=5,
             backbone=dict(depth=18))
img_size = (64, 128)
bf16 = False
data = dict(
    samples_per_gpu=4,
    max_gt=8,
    train=dict(ann_file={ann!r}, img_prefix={img!r}),
    val=dict(ann_file={ann!r}, img_prefix={img!r}),
)
test_cfg = dict(iou_calculator="sph2pob_efficient", nms_pre=NMS_PRE)
frozen_prefixes = ()
"""


def _said(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert fn() in (0, None)
    return out.getvalue()


class _Decoded:
    """A ``cv2.VideoCapture`` that gives decoded RGB frames, as BGR."""

    def __init__(self, frames, fps):
        self.frames, self.fps = list(frames), fps

    def isOpened(self):
        return True

    def get(self, prop):
        assert prop == cv2.CAP_PROP_FPS
        return self.fps

    def read(self):
        if not self.frames:
            return False, None
        return True, cv2.cvtColor(self.frames.pop(0), cv2.COLOR_RGB2BGR)

    def release(self):
        pass


def _recorded(fn, results: list):
    """``inference_detector`` that also appends each image's result."""
    def wrapper(det, imgs):
        out = fn(det, imgs)
        results.extend(out if isinstance(imgs, (list, tuple)) else [out])
        return out
    return wrapper


def _jax_detector(cfg_path, npz):
    """What the JAX package's ``init_detector(cfg_path, npz)`` returns,
    without the random initialisation it overwrites with the file (~16 s
    of eager Flax on the CPU), and with exact preselection (``approx_max_k``
    is a TPU device)."""
    cfg = jax_load_config(cfg_path)
    family = jax_get_family(cfg)
    model, det_cfg = family.build(cfg)
    det_cfg = dataclasses.replace(det_cfg, approx_topk=False)
    params, batch_stats, _ = jax_load_published(npz)
    bv = cfg["model"].get("box_version", 4)
    return japis.Detector(
        model=model, cfg=cfg, det_cfg=det_cfg,
        variables={"params": params, "batch_stats": batch_stats},
        predict=jax.jit(family.predict_fn(model, det_cfg)),
        pipeline=JaxPipeline(img_size=tuple(cfg["img_size"]), training=False,
                             box_version=bv),
        num_classes=cfg["model"]["num_classes"], box_version=bv)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("video_demos")
    ann, img_dir = write_synthetic_coco(str(tmp / "data"), n_images=N_FRAMES,
                                        num_classes=NUM_CLASSES,
                                        box_version=5)
    cfg = str(tmp / "cfg.py")
    with open(cfg, "w") as f:
        f.write(CFG_TMPL.replace("NMS_PRE", str(NMS_PRE)).format(
            classes=NUM_CLASSES, ann=ann, img=img_dir + "/"))
    det = tapis.init_detector(cfg, device="cpu", seed=0)
    bias = det.model.bbox_head.retina_cls.bias
    with torch.no_grad():
        bias.copy_(torch.from_numpy(np.random.default_rng(0).normal(
            *CLS_BIAS, bias.shape).astype(np.float32)))
    npz = save_published(str(tmp / "model.npz"),
                         *to_flax(det.model.state_dict()), {"note": "test"})
    jdet = _jax_detector(cfg, npz)

    avi = str(tmp / "in.avi")
    names = sorted(os.listdir(img_dir))
    writer = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"),
                             30000 / 1001, (128, 64))
    for name in names:
        writer.write(cv2.imread(os.path.join(img_dir, name)))
    writer.release()
    cap = cv2.VideoCapture(avi)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    with open_video(avi) as r:
        frames = list(r)
    assert len(frames) == N_FRAMES and r.fps == fps
    yield {"tmp": tmp, "cfg": cfg, "npz": npz, "jdet": jdet, "avi": avi,
           "frames": frames, "fps": fps}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture
def jax_tool(workspace, monkeypatch):
    """Runs ``tools/<name>.py``'s ``main`` in this process with ``argv``;
    returns what it printed and each image's result as it computed
    them."""
    real_capture = cv2.VideoCapture

    def capture(source, *args):
        if source == workspace["avi"]:
            return _Decoded(workspace["frames"], workspace["fps"])
        return real_capture(source, *args)

    def run(name, argv):
        results = []
        monkeypatch.setattr(cv2, "VideoCapture", capture)
        monkeypatch.setattr(japis, "init_detector",
                            lambda *a, **k: workspace["jdet"])
        monkeypatch.setattr(japis, "inference_detector", _recorded(
            japis.inference_detector, results))
        path = os.path.join(REPO, "tools", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        try:
            return _said(mod.main), results
        finally:
            monkeypatch.undo()

    return run


def _port(module, argv, monkeypatch):
    results = []
    monkeypatch.setattr(module, "inference_detector", _recorded(
        tapis.inference_detector, results))
    try:
        return _said(lambda: module.main(argv)), results
    finally:
        monkeypatch.undo()


def _same_detections(got, want, n):
    assert len(got) >= n and len(want) >= n
    total = 0
    for g_img, w_img in zip(got[:n], want[:n]):
        assert len(g_img) == len(w_img) == NUM_CLASSES
        for g, w in zip(g_img, w_img):
            assert g.shape == w.shape
            np.testing.assert_allclose(g[:, :-1], w[:, :-1], atol=BOX_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(g[:, -1], w[:, -1], atol=SCORE_ATOL,
                                       rtol=0)
            total += len(g)
    assert total > n  # detections were made


def _within(got, want, tolerance):
    assert got.shape == want.shape
    diff = got.astype(np.float64) - want
    mse = float((diff ** 2).mean())
    psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else np.inf
    assert np.abs(diff).mean() <= tolerance["mean"]
    assert psnr >= tolerance["psnr_db"]


@pytest.mark.parametrize("extra, n", [([], N_FRAMES),
                                      (["--max-frames", str(MAX_FRAMES)],
                                       MAX_FRAMES)],
                         ids=["all_frames", "max_frames"])
def test_video_demo_equals_the_jax_tool(workspace, jax_tool, monkeypatch,
                                        extra, n):
    tmp = workspace["tmp"]
    mine, theirs = str(tmp / "port_out.avi"), str(tmp / "jax_out.mp4")
    said_jax, want = jax_tool("video_demo", [
        workspace["avi"], workspace["cfg"], workspace["npz"], "--out",
        theirs, "--batch", str(BATCH), "--device", "cpu", *extra])
    said, got = _port(video_demo, [
        workspace["avi"], workspace["cfg"], workspace["npz"], "--out", mine,
        "--batch", str(BATCH), "--device", "cpu", *extra], monkeypatch)
    assert said.replace(mine, theirs) == said_jax
    assert said.endswith(f"\n{n} frames -> {mine}\n")
    assert len(got) == n  # no padded frame in the port
    _same_detections(got, want, n)

    cap = cv2.VideoCapture(theirs)
    jax_meta = (cap.get(cv2.CAP_PROP_FPS),
                int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                 int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
    cap.release()
    det = tapis.init_detector(workspace["cfg"], workspace["npz"],
                              device="cpu")
    with open_video(mine) as r:
        assert (r.fps, r.frame_count, r.size) == jax_meta \
            == (workspace["fps"], n, (128, 64))
        for frame, result, out in zip(workspace["frames"], got, r):
            shown = tapis.show_result(det, frame, result)
            np.testing.assert_array_equal(out, decode_jpeg(encode_jpeg(
                shown)))
            _within(out, shown, JPEG_TOLERANCE)
    os.remove(mine)
    os.remove(theirs)


def test_webcam_demo_equals_the_jax_tool(workspace, jax_tool, monkeypatch):
    tmp = workspace["tmp"]
    mine, theirs = str(tmp / "port_shots"), str(tmp / "jax_shots")
    argv = ["--source", workspace["avi"], "--max-frames",
            str(WEBCAM_FRAMES), "--device", "cpu"]
    said_jax, want = jax_tool("webcam_demo", [
        workspace["cfg"], workspace["npz"], "--out", theirs, *argv])
    said, got = _port(webcam_demo, [
        workspace["cfg"], workspace["npz"], "--out", mine, *argv],
        monkeypatch)
    assert said.replace(mine, theirs) == said_jax == (
        f"Writing annotated frames to {theirs}\n"
        f"{WEBCAM_FRAMES} frames processed\n")
    assert len(got) == len(want) == WEBCAM_FRAMES
    _same_detections(got, want, WEBCAM_FRAMES)
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs)) == [
        f"frame_{i:06d}.jpg" for i in range(1, WEBCAM_FRAMES + 1)]
    for name in names:
        _within(np.asarray(Image.open(os.path.join(mine, name))),
                np.asarray(Image.open(os.path.join(theirs, name))),
                TOOLS_TOLERANCE)
    shutil.rmtree(mine)
    shutil.rmtree(theirs)


def _no_model(*args, **kwargs):
    raise AssertionError("a model was built")


def test_no_window_and_no_out_exits_before_the_model(workspace,
                                                     monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setattr(webcam_demo, "init_detector", _no_model)
    with pytest.raises(SystemExit, match="pass --out DIR"):
        webcam_demo.main([workspace["cfg"], "--source", workspace["avi"],
                          "--device", "cpu"])


@pytest.mark.parametrize("out", ["out.mkv", "out.gif"])
def test_video_demo_refuses_an_output_suffix(workspace, monkeypatch, out):
    monkeypatch.setattr(video_demo, "init_detector", _no_model)
    path = workspace["tmp"] / out
    with pytest.raises(UnsupportedVideo, match=r"\.avi, \.mp4 or \.mov"):
        video_demo.main([workspace["avi"], workspace["cfg"], "--out",
                         str(path), "--device", "cpu"])
    assert not path.exists()


@pytest.mark.parametrize("demo", ["video_demo", "webcam_demo"])
def test_without_a_card_the_demos_raise_and_write_nothing(workspace, demo):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs")
    out = workspace["tmp"] / ("no_card.avi" if demo == "video_demo"
                              else "no_card")
    argv = ([workspace["avi"], workspace["cfg"], workspace["npz"]]
            if demo == "video_demo" else
            [workspace["cfg"], workspace["npz"], "--source",
             workspace["avi"]]) + ["--out", str(out)]
    with pytest.raises(RuntimeError, match="CUDA"):
        {"video_demo": video_demo, "webcam_demo": webcam_demo}[demo].main(
            argv)
    assert not out.exists()



"""The demo and dataset tools of the port, on the CPU, against the JAX
package's tools run in this process (``tools/<name>.py`` with ``sys.argv``
set; no process is started):

- ``image_demo``: its PNG is ``show_result(det, img, inference_detector(det,
  img))`` of the same checkpoint, bitwise; it raises without a card unless
  told ``--device cpu``;
- ``browse_dataset`` with and without the pipeline: every PNG bitwise the
  JAX tool's (both pipelines decode through PIL);
- ``vis_kent`` (``--bfov`` with ``--mle`` and ``--samples``, and
  ``--kent``): the figure written, kappa and beta those the JAX tool prints
  (within its 4 digits);
- ``create_result_gif``: the JAX tool's frame count, frame size, duration
  and loop; on flat-colour frames the same pixels;
- ``analyze_logs`` on the JSONL of ``engine/runner.py:MetricLogger``:
  ``cal_train_time``'s text the JAX tool's, the curves' file written.

Every file written is removed at the end (C12).
"""

import contextlib
import importlib.util
import io
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sph_retina_tpu_torch import analyze_logs as logs_cli
from sph_retina_tpu_torch import browse_dataset as browse_cli
from sph_retina_tpu_torch import create_result_gif as gif_cli
from sph_retina_tpu_torch import image_demo as demo_cli
from sph_retina_tpu_torch import vis_kent as kent_cli
from sph_retina_tpu_torch.apis import (
    inference_detector,
    init_detector,
    show_result,
)
from sph_retina_tpu_torch.engine.runner import Checkpointer, MetricLogger
from sph_retina_tpu_torch.train import build_training
from sph_retina_tpu_torch.utils.config import load_config
from utils.synthetic_coco import write_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NUM_CLASSES = 3
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
test_cfg = dict(iou_calculator="sph2pob_efficient")
frozen_prefixes = ()
"""


def _said(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert fn() in (0, None)
    return out.getvalue()


def _jax_tool(name, argv, as_main=False):
    """``tools/<name>.py`` in this process with ``argv``: its ``main()``,
    or the file run as ``__main__`` where it has none."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        if as_main:
            return _said(lambda: runpy.run_path(path, run_name="__main__")
                         and None)
        spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return _said(mod.main)
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A 6-image 5-dof COCO-style set, a config over it and a checkpoint of
    an R18 whose class bias is spread, so that it detects; removed at the
    end."""
    tmp = tmp_path_factory.mktemp("demo_tools")
    ann, img_dir = write_synthetic_coco(str(tmp / "data"), n_images=6,
                                        num_classes=NUM_CLASSES,
                                        box_version=5)
    cfg_path = str(tmp / "cfg.py")
    with open(cfg_path, "w") as f:
        f.write(CFG_TMPL.format(classes=NUM_CLASSES, ann=ann,
                                img=img_dir + "/"))
    model, _, _, optimizer, _ = build_training(load_config(cfg_path), CPU,
                                               seed=0)
    bias = model.bbox_head.retina_cls.bias
    with torch.no_grad():
        bias.copy_(torch.from_numpy(np.random.default_rng(0).normal(
            -0.5, 1.5, bias.shape).astype(np.float32)))
    ckpts = str(tmp / "ckpts")
    Checkpointer(ckpts).save(model, optimizer, epoch=1)
    yield {"tmp": tmp, "cfg": cfg_path, "ckpts": ckpts, "img_dir": img_dir}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture
def pil_decoding(monkeypatch):
    """Both pipelines decode through PIL, not their native decoders."""
    from sph_retina_tpu.data import native_loader
    from sph_retina_tpu_torch.data import native_loader as port_native

    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)


def test_image_demo_draws_show_result(workspace):
    img = os.path.join(workspace["img_dir"], sorted(os.listdir(
        workspace["img_dir"]))[0])
    out = str(workspace["tmp"] / "demo.png")
    said = _said(lambda: demo_cli.main([img, workspace["cfg"],
                                        workspace["ckpts"], "--out", out,
                                        "--device", "cpu"]))
    det = init_detector(workspace["cfg"], workspace["ckpts"], device="cpu")
    result = inference_detector(det, img)
    n = sum(len(r) for r in result)
    assert said.strip() == f"saved {out} with {n} detections" and n > 0
    drawn = np.asarray(Image.open(out))
    np.testing.assert_array_equal(drawn, show_result(det, img, result))
    assert sum(int((r[:, -1] >= 0.3).sum()) for r in result) > 0
    assert not np.array_equal(drawn, det.pipeline.resize(
        det.pipeline.load_image(img)))
    os.remove(out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            demo_cli.main([img, workspace["cfg"], workspace["ckpts"],
                           "--out", out])
        assert not os.path.exists(out)


@pytest.mark.parametrize("extra", [[], ["--no-pipeline"],
                                   ["--split", "val"]])
def test_browse_dataset_equals_the_jax_tool(workspace, pil_decoding, extra):
    mine, theirs = (str(workspace["tmp"] / n) for n in ("port", "jax"))
    argv = [workspace["cfg"], "--max-images", "4", "--seed", "3", *extra]
    said = _said(lambda: browse_cli.main(argv + ["--out-dir", mine]))
    assert said.replace(mine, theirs) == _jax_tool(
        "browse_dataset", argv + ["--out-dir", theirs])
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs)) and len(names) == 4
    raw = [np.asarray(Image.open(os.path.join(workspace["img_dir"],
                                              n)).convert("RGB"))
           for n in sorted(os.listdir(workspace["img_dir"]))[:4]]
    changed = 0
    for name, image in zip(names, raw):
        got = np.asarray(Image.open(os.path.join(mine, name)))
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(os.path.join(theirs, name))))
        changed += got.shape == image.shape and not np.array_equal(got,
                                                                   image)
    assert changed > 0  # boxes were drawn
    shutil.rmtree(mine)
    shutil.rmtree(theirs)


def _kappa_beta(said):
    line = said.strip().splitlines()[-1]
    return [float(p.split("=")[1]) for p in line.split(" -> ")[0].split()]


@pytest.mark.parametrize("argv", [
    ["--bfov", "120", "60", "40", "30", "--mle", "--samples", "200"],
    ["--bfov", "300", "150", "20", "50"],
    ["--kent", "20", "5", "1.0", "0.3", "0.5", "--samples", "100"]],
    ids=["bfov_mle", "bfov_moments", "kent"])
def test_vis_kent_equals_the_jax_tool(workspace, argv, monkeypatch):
    mine, theirs = (str(workspace["tmp"] / n) for n in ("k.png", "kj.png"))
    want = _kappa_beta(_jax_tool("vis_kent", argv + [
        "--img-size", "32", "64", "--out", theirs, "--device", "cpu"]))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    said = _said(lambda: kent_cli.main(argv + [
        "--img-size", "32", "64", "--out", mine, "--device", "cpu"]))
    got = _kappa_beta(said)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    fig = np.asarray(Image.open(mine))
    assert fig.ndim == 3 and fig.shape[0] > 32 and fig.shape[1] > 64
    os.remove(mine)
    os.remove(theirs)


def _gif(path):
    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append((np.asarray(im.convert("RGB")),
                           im.info.get("duration")))
        return frames, im.info.get("loop")


@pytest.mark.parametrize("ncols", [1, 2])
def test_create_result_gif_equals_the_jax_tool(workspace, ncols):
    gallery = workspace["tmp"] / "gallery"
    os.makedirs(gallery / "good", exist_ok=True)
    os.makedirs(gallery / "bad", exist_ok=True)
    for i in range(3):  # flat colours (the JAX test's frames)
        Image.fromarray(np.full((16, 32, 3), i * 60, np.uint8)).save(
            gallery / "good" / f"{i}.png")
    Image.fromarray(np.full((20, 36, 3), 200, np.uint8)).save(
        gallery / "bad" / "x.png")
    mine, theirs = (str(workspace["tmp"] / n) for n in ("p.gif", "j.gif"))
    argv = [str(gallery), "--ncols", str(ncols), "--duration", "0.5"]
    said = _said(lambda: gif_cli.main(argv + ["--out", mine]))
    assert said.replace(mine, theirs) == _jax_tool(
        "create_result_gif", argv + ["--out", theirs])
    got, got_loop = _gif(mine)
    want, want_loop = _gif(theirs)
    assert len(got) == len(want) == -(-4 // ncols)
    assert got_loop == want_loop == 0
    for (a, da), (b, db) in zip(got, want):
        assert a.shape == b.shape == (16, 32 * ncols, 3)
        assert da == db == 500
        np.testing.assert_array_equal(a, b)
    shutil.rmtree(gallery)
    os.remove(mine)
    os.remove(theirs)


def test_analyze_logs_equals_the_jax_tool(workspace, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    work = str(workspace["tmp"] / "work")
    logger = MetricLogger(work, interval=1)
    rng = np.random.default_rng(8)
    step = 0
    for epoch in range(3):
        for _ in range(4):
            step += 1
            logger.log(step, {"loss": 2.0 / step, "loss_cls": rng.random(),
                              "lr": 0.01})
        logger.log(step, {"epoch": epoch, "epoch_time": 3.0 + rng.random()},
                   prefix="epoch")
        logger.log(step, {"AP50": 0.1 * epoch}, prefix="val")
    logger.close()
    log = os.path.join(work, "metrics.jsonl")
    task = ["cal_train_time", log]
    said = _said(lambda: logs_cli.main(task))
    assert said == _jax_tool("analyze_logs", task, as_main=True)
    assert said.startswith("epochs: 3  mean: ")
    out = str(workspace["tmp"] / "curves.png")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    said = _said(lambda: logs_cli.main(["plot_curve", log, "--keys", "loss",
                                        "loss_cls", "AP50", "--out", out]))
    assert said.strip() == f"saved {out}" and os.path.getsize(out) > 0
    shutil.rmtree(work)
    os.remove(out)

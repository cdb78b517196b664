"""Result analysis in the port: ``engine/analysis.py``,
``engine/error_analysis.py``, ``visualize/sph_draw.py``, ``test.py
--save-raw`` and the four tools that read the raw file, against the JAX
package's.

Tolerances: integers (confusion counts, recall counts, gallery ranks) equal;
floats within 1e-6, the tolerance of the mAP between the card and the CPU;
drawings bitwise (the same float64 numpy and the same PIL calls). The
matchers compare IoUs with thresholds exactly, and the two packages' IoUs
differ by up to ~1e-5 (ROADMAP C3, C5): every test first checks that no
det-GT or GT-GT pair of its inputs lies within 1e-4 of a threshold it uses
(0.1, 0.5, 0.75) under either package's IoU, and that no score lies within
1e-6 of a score threshold, so that both sides match the same pairs.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from sph_retina_tpu.engine import analysis as janalysis
from sph_retina_tpu.engine import error_analysis as jerror
from sph_retina_tpu.engine.eval import _pairwise_iou_np as jax_pairwise_iou
from sph_retina_tpu.visualize import sph_draw as jdraw
from sph_retina_tpu_torch import analyze_results as analyze_cli
from sph_retina_tpu_torch import coco_error_analysis as error_cli
from sph_retina_tpu_torch import confusion_matrix as confusion_cli
from sph_retina_tpu_torch import occluded_recall as recall_cli
from sph_retina_tpu_torch import test as test_cli
from sph_retina_tpu_torch.engine import analysis as tanalysis
from sph_retina_tpu_torch.engine import error_analysis as terror
from sph_retina_tpu_torch.engine.eval import _pairwise_iou_np as port_iou
from sph_retina_tpu_torch.engine.runner import Checkpointer
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.train import build_training
from sph_retina_tpu_torch.utils.config import load_config
from sph_retina_tpu_torch.visualize import (
    draw_boxes,
    erp_box_polyline,
    imshow_det_bboxes,
)
from sph_retina_tpu_torch import visualize as tvisualize
from utils.synthetic_coco import write_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
IOU_THRS = (0.1, 0.5, 0.75)
SCORE_THRS = (0.3,)
RAW_KEYS = {"boxes", "scores", "labels", "valid", "gt_boxes", "gt_labels",
            "gt_mask", "ig_boxes", "ig_labels", "ig_mask", "img_id"}
NUM_CLASSES = 3


def seeded_raw(seed: int, n_images=10, k=12, g=5, d=4) -> dict:
    """Padded raw result arrays: per image 1..g GT (some across the seam,
    some overlapping another), detections jittered from the GT with mostly
    their class, plus a few random ones; scores uniform."""
    rng = np.random.default_rng(seed)
    arrays = {key: [] for key in RAW_KEYS}
    for i in range(n_images):
        n_gt = int(rng.integers(1, g + 1))
        gt = generate_boxes(n_gt, d, seed=seed * 100 + i,
                            fov_range=(15.0, 50.0),
                            phi_range=(40.0, 140.0))
        if i % 3 == 0:
            gt[0, 0] = 4.0  # across the theta seam
        if n_gt > 1 and i % 2 == 0:
            gt[1, :2] = gt[0, :2] + 6.0  # overlapping the first
        gt_labels = rng.integers(0, NUM_CLASSES, n_gt)
        n_det = int(rng.integers(0, k + 1))
        src = rng.integers(0, n_gt, n_det)
        det = gt[src] + rng.normal(0.0, 4.0, (n_det, d)).astype(np.float32)
        det[:, 0] = np.mod(det[:, 0], 360.0)
        det[:, 2:4] = np.abs(det[:, 2:4]) + 5.0
        n_rand = n_det // 4
        det[:n_rand] = generate_boxes(n_rand, d, seed=seed * 100 + 50 + i,
                                      fov_range=(15.0, 50.0))
        labels = np.where(rng.random(n_det) < 0.8, gt_labels[src],
                          rng.integers(0, NUM_CLASSES, n_det))
        scores = rng.uniform(0.05, 1.0, n_det).astype(np.float32)

        def pad(x, n, fill=0):
            out = np.full((n,) + x.shape[1:], fill, x.dtype)
            out[:len(x)] = x
            return out

        arrays["boxes"].append(pad(det.astype(np.float32), k))
        arrays["scores"].append(pad(scores, k))
        arrays["labels"].append(pad(labels.astype(np.int32), k))
        arrays["valid"].append(np.arange(k) < n_det)
        arrays["gt_boxes"].append(pad(gt.astype(np.float32), g))
        arrays["gt_labels"].append(pad(gt_labels.astype(np.int32), g))
        arrays["gt_mask"].append(np.arange(g) < n_gt)
        arrays["ig_boxes"].append(np.ones((1, d), np.float32))
        arrays["ig_labels"].append(np.zeros(1, np.int32))
        arrays["ig_mask"].append(np.zeros(1, bool))
        arrays["img_id"].append(np.int64(i))
    return {key: np.stack(v) for key, v in arrays.items()}


def assert_away_from_thresholds(arrays: dict, backends) -> None:
    """No pair within 1e-4 of an IoU threshold under either package's IoU,
    no score within 1e-6 of 0.3. (A box with itself, the GT-GT diagonal,
    sits near 1.0, where the packages differ most, C5: far from all.)"""
    for i in range(arrays["boxes"].shape[0]):
        det, scores, _, gt, _ = tanalysis._unpack(arrays, i)
        assert np.abs(scores[:, None] - np.asarray(SCORE_THRS)).min(
            initial=1.0) > 1e-6
        for backend in backends:
            for a, b in ((det, gt), (gt, gt)):
                if not (len(a) and len(b)):
                    continue
                mine = port_iou(a, b, backend, device=CPU)
                theirs = np.asarray(jax_pairwise_iou(a, b, backend))
                for iou in (mine, theirs):
                    dist = np.abs(iou[..., None] - np.asarray(IOU_THRS)).min()
                    assert dist > 1e-4, (
                        f"image {i}, {backend}: a pair within {dist:.2e} of "
                        "an IoU threshold; choose other inputs (C3)")


@pytest.fixture(scope="module")
def raw():
    arrays = seeded_raw(seed=3)
    assert_away_from_thresholds(arrays, ("sph2pob_efficient", "unbiased"))
    return arrays


def test_confusion_matrix_equals_the_jax_packages(raw):
    for kw in ({}, {"score_thr": 0.0, "iou_thr": 0.1}):
        got = tanalysis.confusion_matrix(raw, NUM_CLASSES, device=CPU, **kw)
        want = janalysis.confusion_matrix(raw, NUM_CLASSES, **kw)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert got[:NUM_CLASSES, :NUM_CLASSES].trace() > 0  # not all misses
    assert got[NUM_CLASSES].sum() > 0 and got[:, NUM_CLASSES].sum() > 0


def test_per_image_scores_equal_the_jax_packages(raw):
    got = tanalysis.per_image_scores(raw, NUM_CLASSES, device=CPU)
    want = janalysis.per_image_scores(raw, NUM_CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert len(np.unique(np.round(got, 6))) > 2  # a ranking, not a tie


def test_occluded_separated_recall_equals_the_jax_packages(raw):
    got = tanalysis.occluded_separated_recall(raw, device=CPU, iou_thr=0.5)
    want = janalysis.occluded_separated_recall(raw, iou_thr=0.5)
    assert got.keys() == want.keys()
    for k in got:
        if k.endswith("_total"):
            assert got[k] == want[k] and isinstance(got[k], int), k
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
    assert got["occluded_total"] > 0 and got["separated_total"] > 0
    assert 0.0 < got["all_recall"] < 1.0


def test_error_decomposition_equals_the_jax_packages(raw):
    dets, anns = [], []
    for i in range(raw["boxes"].shape[0]):
        det, scores, labels, gt, gt_labels = tanalysis._unpack(raw, i)
        dets.append((det, scores, labels))
        anns.append({"boxes": gt, "labels": gt_labels})
    got = terror.error_decomposition(dets, anns, NUM_CLASSES, device=CPU)
    want = jerror.error_decomposition(dets, anns, NUM_CLASSES)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["ps"], want["ps"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-6, rtol=0)
    assert terror.ERROR_TYPES == jerror.ERROR_TYPES
    ap = got["ap"][:, got["valid"]].mean(axis=1)
    assert np.all(np.diff(ap) >= 0) and 0.0 < ap[0] < ap[-1] == 1.0


def test_raw_files_are_read_by_either_package(raw, tmp_path):
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tanalysis.save_raw_results(mine, raw)
    janalysis.save_raw_results(theirs, raw)
    for path in (mine, theirs):
        for load in (tanalysis.load_raw_results, janalysis.load_raw_results):
            got = load(path)
            assert got.keys() == raw.keys()
            for k in raw:
                assert got[k].dtype == raw[k].dtype, k
                np.testing.assert_array_equal(got[k], raw[k])
        os.remove(path)


# --------------------------------------------------- drawing spherical boxes
def _draw_inputs():
    boxes4 = generate_boxes(6, 4, seed=5, fov_range=(10.0, 80.0))
    boxes4[0, 0] = 2.0  # across the seam: split polylines
    boxes5 = generate_boxes(6, 5, seed=6, fov_range=(10.0, 80.0))
    image = np.random.default_rng(7).integers(0, 256, (96, 192, 3),
                                              dtype=np.uint8)
    return boxes4, boxes5, image


def test_drawing_equals_the_jax_packages():
    boxes4, boxes5, image = _draw_inputs()
    for box in list(boxes4) + list(boxes5):
        got = erp_box_polyline(box, (96, 192))
        want = jdraw.erp_box_polyline(box, (96, 192))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(erp_box_polyline(boxes4[0], (96, 192))) > 1
    labels = np.arange(6) % 4
    scores = np.linspace(0.1, 0.9, 6)
    for kw in ({}, {"labels": labels}, {"labels": labels, "scores": scores,
                                         "score_thr": 0.3},
               {"labels": labels, "class_names": ["a", "b", "c"],
                "color": (0, 220, 0), "width": 3}):
        for boxes in (boxes4, boxes5):
            got = draw_boxes(image, boxes, **kw)
            want = jdraw.draw_boxes(image, boxes, **kw)
            assert got.dtype == np.uint8 and got.shape == image.shape
            np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, image)
    with_scores = np.concatenate([boxes4, scores[:, None]], axis=1)
    np.testing.assert_array_equal(
        imshow_det_bboxes(image, with_scores, labels),
        jdraw.imshow_det_bboxes(image, with_scores, labels))
    np.testing.assert_array_equal(  # a 5-dof box's angle is not a score
        imshow_det_bboxes(image, boxes5, labels, score_thr=0.5),
        jdraw.imshow_det_bboxes(image, boxes5, labels, score_thr=0.5))
    from sph_retina_tpu import visualize as jvisualize

    assert set(tvisualize.__all__) == set(jvisualize.__all__)


# ------------------------------------ test.py --save-raw and the tool twins
CFG_TMPL = """\
model = dict(type="SphRetinaNet", num_classes={classes}, backbone=dict(depth=18))
img_size = (64, 128)
bf16 = False
data = dict(
    samples_per_gpu=4,
    max_gt=8,
    test=dict(ann_file={ann!r}, img_prefix={img!r}),
)
frozen_prefixes = ()
"""


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert fn() in (0, None)
    return out.getvalue()


def _jax_tool(name, argv):
    """Run ``tools/<name>.py``'s ``main()`` in this process with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        return _quiet(mod.main)
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """A 16-image COCO-style set, a config over it, a checkpoint of an R18
    whose class bias is spread (so that it detects), and the raw files of
    ``test.main --save-raw`` on it and on the synthetic set; everything
    removed at the end."""
    tmp = tmp_path_factory.mktemp("analysis")
    ann, img_dir = write_synthetic_coco(str(tmp / "data"), n_images=16,
                                        num_classes=NUM_CLASSES)
    cfg_path = str(tmp / "cfg.py")
    with open(cfg_path, "w") as f:
        f.write(CFG_TMPL.format(classes=NUM_CLASSES, ann=ann,
                                img=img_dir + "/"))
    cfg = load_config(cfg_path)
    model, _, _, optimizer, _ = build_training(cfg, CPU, seed=0)
    bias = model.bbox_head.retina_cls.bias
    with torch.no_grad():
        bias.copy_(torch.from_numpy(np.random.default_rng(0).normal(
            -0.5, 1.5, bias.shape).astype(np.float32)))
    ckpts = str(tmp / "ckpts")
    Checkpointer(ckpts).save(model, optimizer, epoch=1)
    raw = str(tmp / "raw.npz")
    said = _quiet(lambda: test_cli.main([cfg_path, ckpts, "--device", "cpu",
                                         "--save-raw", raw]))
    synthetic = str(tmp / "synthetic_raw.npz")
    _quiet(lambda: test_cli.main([cfg_path, ckpts, "--device", "cpu",
                                  "--synthetic", "--save-raw", synthetic]))
    yield {"tmp": tmp, "cfg": cfg_path, "raw": raw, "synthetic": synthetic,
           "said": said}
    shutil.rmtree(tmp, ignore_errors=True)


def test_save_raw_writes_the_jax_layout(evaluated):
    assert f"raw results -> {evaluated['raw']}" in evaluated["said"]
    for path, n in ((evaluated["raw"], 16), (evaluated["synthetic"], 16)):
        arrays = janalysis.load_raw_results(path)
        assert set(arrays) == RAW_KEYS
        assert all(v.shape[0] == n for v in arrays.values())
        assert arrays["boxes"].shape[-1] == arrays["gt_boxes"].shape[-1] == 4
        assert arrays["valid"].dtype == bool and arrays["valid"].any()
    arrays = janalysis.load_raw_results(evaluated["raw"])
    assert sorted(arrays["img_id"]) == list(range(1, 17))
    assert (arrays["scores"][arrays["valid"]] >= 0.3).any()
    assert_away_from_thresholds(arrays, ("sph2pob_efficient", "unbiased"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_confusion_matrix_tool_equals_the_jax_tools(evaluated, monkeypatch):
    """The port's figure is written with matplotlib unimportable."""
    tmp, cfg, raw = evaluated["tmp"], evaluated["cfg"], evaluated["raw"]
    mine, theirs = str(tmp / "cm_port"), str(tmp / "cm_jax")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        said = _quiet(lambda: confusion_cli.main([cfg, raw, mine, "--device",
                                                  "cpu"]))
    _jax_tool("confusion_matrix", [cfg, raw, theirs, "--device", "cpu"])
    assert "matched GT:" in said
    assert _files(mine) == _files(theirs) == ["confusion_matrix.npy",
                                              "confusion_matrix.png"]
    cm = np.load(os.path.join(mine, "confusion_matrix.npy"))
    np.testing.assert_array_equal(
        cm, np.load(os.path.join(theirs, "confusion_matrix.npy")))
    assert cm.shape == (NUM_CLASSES + 1,) * 2 and cm.sum() > 0
    assert os.path.getsize(os.path.join(mine, "confusion_matrix.png")) > 0


def test_coco_error_analysis_tool_equals_the_jax_tools(evaluated,
                                                      monkeypatch):
    """The port's figures are written with matplotlib unimportable."""
    tmp, cfg, raw = evaluated["tmp"], evaluated["cfg"], evaluated["raw"]
    mine, theirs = str(tmp / "err_port"), str(tmp / "err_jax")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        _quiet(lambda: error_cli.main([cfg, raw, mine, "--device", "cpu"]))
    _jax_tool("coco_error_analysis", [cfg, raw, theirs, "--device", "cpu"])
    files = _files(mine)
    assert files == _files(theirs)
    assert "bbox-allclass-allarea.png" in files and len(files) >= 3
    for name in files:
        assert os.path.getsize(os.path.join(mine, name)) > 0, name
    with open(os.path.join(mine, "error_analysis.json")) as f:
        got = json.load(f)
    with open(os.path.join(theirs, "error_analysis.json")) as f:
        want = json.load(f)
    assert list(got) == list(want) == list(terror.ERROR_TYPES)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["FN"] == 1.0


def test_occluded_recall_tool_equals_the_jax_tools(evaluated):
    tmp, raw = evaluated["tmp"], evaluated["raw"]
    for extra in ([], ["--iou-thr", "0.1", "--score-thr", "0.05"]):
        mine, theirs = str(tmp / "rec_port.json"), str(tmp / "rec_jax.json")
        _quiet(lambda: recall_cli.main([raw, "--device", "cpu", "--out",
                                        mine, *extra]))
        _jax_tool("occluded_recall", [raw, "--device", "cpu", "--out",
                                      theirs, *extra])
        with open(mine) as f:
            got = json.load(f)
        with open(theirs) as f:
            want = json.load(f)
        assert got.keys() == want.keys()
        for k in got:
            if k.endswith("_total"):
                assert got[k] == want[k], k
            elif np.isnan(want[k]):
                assert np.isnan(got[k]), k
            else:
                assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["all_total"] > 0


def test_analyze_results_tool_equals_the_jax_tools(evaluated):
    """The galleries: the same images at the same ranks (the file names
    carry rank, per-image mAP and image id) with the same pixels; then the
    two-model comparison against a copy whose odd rows predict other
    classes."""
    tmp, cfg, raw = evaluated["tmp"], evaluated["cfg"], evaluated["raw"]
    arrays = tanalysis.load_raw_results(raw)
    odd = np.arange(arrays["labels"].shape[0])[:, None] % 2 == 1
    arrays["labels"] = np.where(odd, (arrays["labels"] + 1) % NUM_CLASSES,
                                arrays["labels"])
    second = str(tmp / "second.npz")
    tanalysis.save_raw_results(second, arrays)
    for extra in ([], ["--compare", second]):
        mine, theirs = str(tmp / "ana_port"), str(tmp / "ana_jax")
        _quiet(lambda: analyze_cli.main([cfg, raw, mine, "--device", "cpu",
                                         "--topk", "4", *extra]))
        _jax_tool("analyze_results", [cfg, raw, theirs, "--device", "cpu",
                                      "--topk", "4", *extra])
        files = _files(mine)
        assert files == _files(theirs) and len(files) >= 8
        from PIL import Image

        for name in files:
            np.testing.assert_array_equal(
                np.asarray(Image.open(os.path.join(mine, name))),
                np.asarray(Image.open(os.path.join(theirs, name))))
        shutil.rmtree(mine)
        shutil.rmtree(theirs)
    assert any(name.startswith("model1_better") for name in files)

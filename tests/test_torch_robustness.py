"""The robustness benchmark and the offline scoring tools of the port
against the JAX package's, on the CPU.

- ``evaluate_dataset`` over the port's ``CorruptedDataset`` against the JAX
  package's over its own: the rotated config at R18 64x128, Flax weights
  carried across with ``from_flax``, ``gaussian_noise`` at severity 3
  (bitwise the same images), the JAX matcher given the port's IoUs (C7);
  as ``tests/test_torch_eval.py``: validity and labels equal, scores 1e-4,
  boxes 5e-3 degrees, metrics equal at low thresholds.
- ``test_robustness.main``: the JAX tool's JSON layout; its clean entry
  equal to ``test.main``'s metrics on the same checkpoint and images.
- ``robustness_eval.get_results``, ``eval_metric.main`` (COCO-style and
  ``--voc``) and ``eval_pr_curve.pr_curves``: equal to the JAX tools' (run
  in this process) on the same files, the JAX matcher given the port's
  IoUs; ``eval_pr_curve``'s figure written with matplotlib unimportable.
- Without a card and without ``--device cpu`` each CLI raises.

Every file written is removed once asserted on (C12).
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.data import DataLoader as JaxDataLoader
from sph_retina_tpu.data import SphCocoDataset as JaxCocoDataset
from sph_retina_tpu.data import SphPipeline as JaxPipeline
from sph_retina_tpu.data import corruptions as jc
from sph_retina_tpu.engine import eval as jeval
from sph_retina_tpu.engine import evaluator as jevaluator
from sph_retina_tpu.engine.zoo import get_family as jax_get_family
from sph_retina_tpu_torch import eval_metric as metric_cli
from sph_retina_tpu_torch import eval_pr_curve as pr_cli
from sph_retina_tpu_torch import robustness_eval as summary_cli
from sph_retina_tpu_torch import test as test_cli
from sph_retina_tpu_torch import test_robustness as robust_cli
from sph_retina_tpu_torch.data import DataLoader, SphCocoDataset, SphPipeline
from sph_retina_tpu_torch.data import corruptions as tc
from sph_retina_tpu_torch.engine import evaluator as tevaluator
from sph_retina_tpu_torch.engine.analysis import (
    _unpack,
    load_raw_results,
    save_raw_results,
)
from sph_retina_tpu_torch.engine.eval import _pairwise_iou_np as port_iou
from sph_retina_tpu_torch.engine.runner import Checkpointer
from sph_retina_tpu_torch.engine.zoo import get_family
from sph_retina_tpu_torch.models.from_flax import load_flax_variables
from sph_retina_tpu_torch.train import build_training
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config

from test_torch_model import randomize
from utils.synthetic_coco import write_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROTATED = os.path.join(REPO, "configs",
                       "sph_rotated_retinanet_r50_fpn_120e_pandora.py")
CPU = torch.device("cpu")
H, W = 64, 128
NUM_CLASSES = 3
LOW_THRS = (0.05, 0.1, 0.2, 0.5)
CFG_TMPL = """\
_base_ = [{base!r}]
model = dict(num_classes={classes}, backbone=dict(depth=18))
img_size = ({h}, {w})
bf16 = False
data = dict(samples_per_gpu=4, max_gt=8)
test_cfg = dict(nms_pre=100)
"""


def _port_iou(det_boxes, gt_boxes, backend, max_det=128, max_gt=64):
    return port_iou(det_boxes, gt_boxes, backend, device=CPU)


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert fn() in (0, None)
    return out.getvalue()


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, argv):
    """``tools/<name>.py``'s ``main()`` in this process with ``argv``."""
    mod = _jax_tool(name)
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        return _quiet(mod.main)
    finally:
        sys.argv = saved


# ------------------------------------------- evaluate_dataset, both packages
def test_evaluate_dataset_over_corrupted_sets_equals_the_jax_packages(
        tmp_path, monkeypatch):
    ann, img_dir = write_synthetic_coco(str(tmp_path), n_images=8,
                                        num_classes=NUM_CLASSES,
                                        img_size=(H, W), box_version=5)
    cfg = apply_overrides(load_config(ROTATED), [
        "model.backbone.depth=18", f"img_size=({H},{W})", "bf16=False",
        "data.max_gt=8", "test_cfg.nms_pre=100"])
    cfg["model"]["num_classes"] = NUM_CLASSES
    jfam = jax_get_family(cfg)
    jmodel, jdet = jfam.build(cfg)
    jdet = dataclasses.replace(jdet, approx_topk=False)
    variables = jfam.init(jmodel, jax.random.PRNGKey(0),
                          jnp.zeros((1, H, W, 3)))
    rng = np.random.default_rng(1)
    params = randomize(jax.device_get(variables["params"]), rng)
    stats = randomize(jax.device_get(variables.get("batch_stats", {})), rng)
    tfam = get_family(cfg)
    tmodel, tdet = tfam.build(cfg)
    load_flax_variables(tmodel, params, stats)

    kw = dict(ann_file=ann, img_prefix=img_dir + "/", box_version=5)
    tds = tc.CorruptedDataset(SphCocoDataset(**kw), "gaussian_noise", 3,
                              seed=2)
    jds = jc.CorruptedDataset(JaxCocoDataset(**kw), "gaussian_noise", 3,
                              seed=2)
    tloader = DataLoader(tds, SphPipeline(img_size=(H, W), training=False,
                                          box_version=5),
                         batch_size=4, shuffle=False, drop_last=False)
    jloader = JaxDataLoader(jds, JaxPipeline(img_size=(H, W), training=False,
                                             box_version=5),
                            batch_size=4, shuffle=False, drop_last=False)
    for g, w in zip(tloader.epoch(0), jloader.epoch(0)):  # the same images
        np.testing.assert_array_equal(g["images"], w["images"])
    monkeypatch.setattr(jeval, "_pairwise_iou_np", _port_iou)
    want, jraw = jevaluator.evaluate_dataset(
        jmodel, jdet, {"params": params, "batch_stats": stats}, jloader,
        iou_thrs=LOW_THRS, predict=jax.jit(jfam.predict_fn(jmodel, jdet)),
        return_raw=True)
    got, traw = tevaluator.evaluate_dataset(
        tmodel, tdet, tloader, iou_thrs=LOW_THRS,
        predict=tfam.predict_fn(tmodel, tdet), return_raw=True)

    assert traw.keys() == jraw.keys()
    v = jraw["valid"]
    np.testing.assert_array_equal(traw["valid"], v)
    assert v.sum() > 20
    np.testing.assert_array_equal(traw["labels"][v], jraw["labels"][v])
    np.testing.assert_allclose(traw["scores"][v], jraw["scores"][v],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(traw["boxes"][v], jraw["boxes"][v],
                               atol=5e-3, rtol=0)
    for k in ("gt_boxes", "gt_labels", "gt_mask", "ig_boxes", "ig_labels",
              "ig_mask", "img_id"):
        np.testing.assert_array_equal(traw[k], jraw[k], err_msg=k)
    assert got["n_images"] == want["n_images"] == 8
    for k in ("mAP", "AP50", "AP75"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["per_class"], want["per_class"])
    assert got["mAP"] > 0


# ------------------------------------------------------------ the CLI tools
@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """A config (the rotated one at R18 64x128, 3 classes, ``nms_pre``
    100), a checkpoint whose class bias is spread (so that it detects),
    ``test.main --synthetic --save-raw --out`` on it, and
    ``test_robustness.main`` on the same 16 synthetic images; everything
    removed at the end."""
    tmp = tmp_path_factory.mktemp("robustness")
    cfg_path = str(tmp / "cfg.py")
    with open(cfg_path, "w") as f:
        f.write(CFG_TMPL.format(base=ROTATED, classes=NUM_CLASSES, h=H, w=W))
    model, _, _, optimizer, _ = build_training(load_config(cfg_path), CPU,
                                               seed=0)
    bias = model.bbox_head.retina_cls.bias
    with torch.no_grad():
        bias.copy_(torch.from_numpy(np.random.default_rng(0).normal(
            -0.5, 1.5, bias.shape).astype(np.float32)))
    ckpts = str(tmp / "ckpts")
    Checkpointer(ckpts).save(model, optimizer, epoch=1)
    raw, metrics = str(tmp / "raw.npz"), str(tmp / "metrics.json")
    _quiet(lambda: test_cli.main([cfg_path, ckpts, "--device", "cpu",
                                  "--synthetic", "--save-raw", raw,
                                  "--out", metrics]))
    robust = str(tmp / "robust.json")
    said = _quiet(lambda: robust_cli.main([
        cfg_path, ckpts, "--synthetic", "--device", "cpu", "--corruptions",
        "gaussian_noise", "motion_blur", "--severities", "0", "3",
        "--out", robust]))
    yield {"tmp": tmp, "cfg": cfg_path, "ckpts": ckpts, "raw": raw,
           "metrics": metrics, "robust": robust, "said": said}
    shutil.rmtree(tmp, ignore_errors=True)


def test_robustness_tool_writes_the_jax_layout(evaluated):
    with open(evaluated["robust"]) as f:
        results = json.load(f)
    with open(evaluated["metrics"]) as f:
        clean = json.load(f)
    assert list(results) == ["clean", "gaussian_noise", "motion_blur"]
    assert list(results["clean"]) == ["0"]
    assert list(results["gaussian_noise"]) == list(results["motion_blur"]) \
        == ["3"]
    keys = set(clean)
    assert {"mAP", "AP50", "AP75"} <= keys
    for name, sevs in results.items():
        for metrics in sevs.values():
            assert set(metrics) == keys
            assert all(isinstance(v, float) and np.isfinite(v)
                       for v in metrics.values())
    assert results["clean"]["0"] == clean
    assert f"wrote {evaluated['robust']}" in evaluated["said"]
    assert "loaded checkpoint at step" in evaluated["said"]
    assert "motion_blur severity=3" in evaluated["said"]


def test_robustness_summary_equals_the_jax_tools(evaluated, tmp_path):
    jax_tool = _jax_tool("robustness_eval")
    handmade = tmp_path / "handmade.json"
    handmade.write_text(json.dumps({
        "clean": {"0": {"AP50": 0.8, "mAP": 0.5}},
        "gaussian_noise": {"1": {"AP50": 0.6}, "2": {"AP50": 0.4}},
        "fog": {"1": {"AP50": 0.5}, "0": {"AP50": 0.9}},
        "snow": {}}))
    for path, metric in ((evaluated["robust"], "AP50"),
                         (evaluated["robust"], "mAP"),
                         (str(handmade), "AP50")):
        got = summary_cli.get_results(path, metric)
        assert got == jax_tool.get_results(path, metric)
    got = summary_cli.get_results(str(handmade))
    np.testing.assert_allclose(got["mPC"], (0.6 + 0.4 + 0.5) / 3)
    assert _quiet(lambda: summary_cli.main([str(handmade)])) \
        == _run_jax_tool("robustness_eval", [str(handmade)])


def _jittered_ground_truth(arrays: dict, seed: int) -> dict:
    """Raw arrays whose detections are each image's ground truth, moved by
    up to 3 degrees, with seeded scores: a set the matchers match."""
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    n = min(arrays["boxes"].shape[1], arrays["gt_boxes"].shape[1])
    boxes = np.zeros_like(arrays["boxes"])
    boxes[:, :n] = arrays["gt_boxes"][:, :n]
    boxes[:, :, :4] += rng.uniform(-3.0, 3.0, boxes[:, :, :4].shape)
    boxes[:, :, 2:4] = np.abs(boxes[:, :, 2:4]) + 1.0
    out["boxes"] = boxes.astype(np.float32)
    out["labels"] = np.zeros_like(arrays["labels"])
    out["labels"][:, :n] = arrays["gt_labels"][:, :n]
    out["valid"] = np.zeros_like(arrays["valid"])
    out["valid"][:, :n] = arrays["gt_mask"][:, :n]
    out["scores"] = rng.uniform(0.05, 1.0, arrays["scores"].shape).astype(
        np.float32)
    return out


@pytest.fixture(scope="module")
def jittered(evaluated):
    path = str(evaluated["tmp"] / "jittered.npz")
    save_raw_results(path, _jittered_ground_truth(
        load_raw_results(evaluated["raw"]), seed=5))
    return path


@pytest.mark.parametrize("extra", [[], ["--iou-thrs", "0.1", "0.5"],
                                   ["--voc"], ["--voc", "--iou-thrs", "0.3"]],
                         ids=["coco", "coco-thrs", "voc", "voc-0.3"])
def test_eval_metric_equals_the_jax_tools(evaluated, jittered, extra,
                                          monkeypatch):
    monkeypatch.setattr(jeval, "_pairwise_iou_np", _port_iou)
    tmp = evaluated["tmp"]
    for raw in (evaluated["raw"], jittered):
        mine, theirs = str(tmp / "m_port.json"), str(tmp / "m_jax.json")
        _quiet(lambda: metric_cli.main([evaluated["cfg"], raw, "--device",
                                        "cpu", "--out", mine, *extra]))
        _run_jax_tool("eval_metric", [evaluated["cfg"], raw, "--device",
                                      "cpu", "--out", theirs, *extra])
        with open(mine) as f:
            got = json.load(f)
        with open(theirs) as f:
            want = json.load(f)
        assert got == want
    # the jittered set matches: the comparison is not of zeros
    assert got["mAP"] > 0.3
    if "--voc" not in extra:
        with open(evaluated["metrics"]) as f:
            clean = json.load(f)
        got = json.loads(_quiet(lambda: metric_cli.main(
            [evaluated["cfg"], evaluated["raw"], "--device", "cpu"])))
        assert got == clean  # test.main's metrics, re-scored


def _jax_tools_curves(dets, anns, num_classes, iou_thr, backend):
    """``tools/eval_pr_curve.py``'s matching loop and the JAX package's
    ``_average_precision``; a detection's IoU row is its row of the port's
    IoU matrix of its image (the tool computes it alone)."""
    rows = [_port_iou(boxes, np.asarray(ann["boxes"]), backend)
            for (boxes, _, _), ann in zip(dets, anns)]
    curves = {}
    for c in range(num_classes):
        recs, n_gt, matched = [], 0, []
        for i, ((boxes, scores, labels), ann) in enumerate(zip(dets, anns)):
            gt_idx = np.where(np.asarray(ann["labels"]) == c)[0]
            matched.append(np.zeros(len(gt_idx), bool))
            n_gt += len(gt_idx)
            for k in np.where(labels == c)[0]:
                recs.append((float(scores[k]), i, int(k), gt_idx))
        if n_gt == 0:
            continue
        recs.sort(key=lambda r: -r[0])
        tp = np.zeros(len(recs))
        for r_i, (_, img, k, gt_idx) in enumerate(recs):
            if len(gt_idx) == 0:
                continue
            ious = rows[img][k, gt_idx]
            cand = np.where(~matched[img], ious, -1.0)
            best = int(np.argmax(cand)) if len(cand) else -1
            if best >= 0 and cand[best] >= iou_thr:
                matched[img][best] = True
                tp[r_i] = 1
        ctp = np.cumsum(tp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(np.arange(1, len(recs) + 1), 1)
        curves[c] = (recall, precision,
                     jeval._average_precision(recall, precision))
    return curves


@pytest.mark.parametrize("iou_thr", [0.5, 0.75])
def test_pr_curves_equal_the_jax_tools(evaluated, jittered, iou_thr,
                                       monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for raw in (jittered, evaluated["raw"]):
        arrays = load_raw_results(raw)
        dets, anns = [], []
        for i in range(arrays["boxes"].shape[0]):
            boxes, scores, labels, gt_boxes, gt_labels = _unpack(arrays, i)
            dets.append((boxes, scores, labels))
            anns.append({"boxes": gt_boxes, "labels": gt_labels})
        got = pr_cli.pr_curves(dets, anns, NUM_CLASSES, iou_thr,
                               "sph2pob_efficient", CPU)
        want = _jax_tools_curves(dets, anns, NUM_CLASSES, iou_thr,
                                 "sph2pob_efficient")
        assert got.keys() == want.keys() and len(got) > 0
        for c in want:
            for a, b in zip(got[c], want[c]):
                np.testing.assert_array_equal(a, b)
    assert 0 < max(ap for _, _, ap in got.values()) < 1 or raw != jittered


def test_pr_curve_tool_with_and_without_matplotlib(evaluated, monkeypatch):
    """The figure is drawn by ``visualize/canvas.py``: written whether or
    not matplotlib can be imported, the same file both times."""
    out = str(evaluated["tmp"] / "pr.png")
    argv = [evaluated["cfg"], evaluated["ckpts"], "--synthetic", "--device",
            "cpu", "--out", out]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        said = _quiet(lambda: pr_cli.main(argv))
    assert f"saved {out}" in said and os.path.getsize(out) > 0
    assert said.count("AP=") == len(said.splitlines()) - 1 >= 1
    with open(out, "rb") as f:
        first = f.read()
    os.remove(out)
    said = _quiet(lambda: pr_cli.main(argv))
    assert f"saved {out}" in said
    with open(out, "rb") as f:
        assert f.read() == first


def test_the_tools_need_a_card_unless_told_cpu(evaluated):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg, ckpts, raw = evaluated["cfg"], evaluated["ckpts"], evaluated["raw"]
    for main, argv in ((robust_cli.main, [cfg, ckpts, "--synthetic"]),
                       (metric_cli.main, [cfg, raw]),
                       (pr_cli.main, [cfg, ckpts, "--synthetic"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)

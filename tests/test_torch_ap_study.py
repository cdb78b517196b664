"""The port's AP study and detection diagnosis
(``sph_retina_tpu_torch/ap_study.py``, ``detection_diagnosis.py``) against
the JAX package's (``tools/ap_study.py``, ``tools/detection_diagnosis.py``).

- ``stratified_metrics`` of both on the same seeded evaluation arrays: AP50
  and mAP within 1e-6 in every stratum;
- ``_orderings``, ``merge_reports`` and ``write_markdown`` of both on the
  same seeded reports: equal, and the markdown text equal but for the
  header's citation of the reference's README (the port names it without
  a path);
- ``run_study(quick=True, max_epochs=1, variants=[("ciou", [])],
  device="cpu")``: a well-formed report over 12 val images, the fused
  kernel's plain version called once a step at (192, 6 138) D=4 (the op's
  CPU kernel), ``eval_arrays.npz`` and both files written;
- ``diagnose`` of both on a seeded ``eval_arrays.npz`` whose detections are
  GTs jittered by at least 0.05 degree (off the C5 thresholds): integers
  equal, floats within 1e-4.

Everything written lies under ``tmp_path`` and is removed once the test is
done; ``torch.utils.tensorboard`` is made unimportable (it imports
TensorFlow where that is installed).
"""

import importlib.util
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

from sph_retina_tpu_torch import ap_study as port
from sph_retina_tpu_torch import detection_diagnosis as port_diag
from sph_retina_tpu_torch.ops import sph2pob_iou

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_study = _load("ap_study")
jax_diag = _load("detection_diagnosis")


@pytest.fixture
def emptied_tmp_path(tmp_path):
    """``tmp_path``, emptied once the test is done with it."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _eval_arrays(seed: int, n_img=12, g=5, k=20, classes=3) -> dict:
    """Evaluation arrays as ``evaluate_dataset(return_raw=True)`` gives
    them: GTs, and detections that are GTs jittered by 0.05-3 degrees with
    seeded scores and labels, plus seeded false positives."""
    rng = np.random.default_rng(seed)
    gt = np.stack([rng.uniform(20, 340, (n_img, g)),
                   rng.uniform(20, 160, (n_img, g)),
                   rng.uniform(10, 60, (n_img, g)),
                   rng.uniform(10, 60, (n_img, g))], -1).astype(np.float32)
    gt_mask = rng.random((n_img, g)) < 0.8
    gt_labels = rng.integers(0, classes, (n_img, g)).astype(np.int32)
    boxes = np.concatenate([gt, gt, gt, gt], axis=1)[:, :k].copy()
    jitter = rng.uniform(0.05, 3.0, boxes.shape) \
        * rng.choice([-1.0, 1.0], boxes.shape)
    boxes = (boxes + jitter).astype(np.float32)
    boxes[:, 2 * g:] = np.stack([rng.uniform(20, 340, (n_img, k - 2 * g)),
                                 rng.uniform(20, 160, (n_img, k - 2 * g)),
                                 rng.uniform(10, 60, (n_img, k - 2 * g)),
                                 rng.uniform(10, 60, (n_img, k - 2 * g))],
                                -1)
    labels = np.concatenate([gt_labels] * 4, axis=1)[:, :k].copy()
    flip = rng.random(labels.shape) < 0.2
    labels[flip] = rng.integers(0, classes, int(flip.sum()))
    return {
        "boxes": boxes, "scores": rng.uniform(0.05, 1.0, (n_img, k))
        .astype(np.float32), "labels": labels.astype(np.int32),
        "valid": rng.random((n_img, k)) < 0.9,
        "gt_boxes": gt, "gt_labels": gt_labels, "gt_mask": gt_mask,
        "ig_boxes": np.ones((n_img, 1, 4), np.float32),
        "ig_labels": np.zeros((n_img, 1), np.int32),
        "ig_mask": np.zeros((n_img, 1), bool),
        "img_id": np.arange(1, n_img + 1, dtype=np.int64),
    }


STRATA_BY_IMG = {i: (("polar",) if i % 3 == 0 else ("seam",) if i % 3 == 1
                     else ()) for i in range(1, 13)}
STRATA_BY_IMG[4] = ("polar", "seam")


def test_stratified_metrics_equal_the_jax_tools():
    arrays = _eval_arrays(seed=1)
    got = port.stratified_metrics(arrays, STRATA_BY_IMG, 3, device="cpu")
    want = jax_study.stratified_metrics(arrays, STRATA_BY_IMG, 3)
    assert list(got) == list(want) == ["polar", "seam", "body"]
    for stratum, m in want.items():
        assert got[stratum]["n_images"] == m["n_images"]
        for key in ("AP50", "mAP"):
            assert abs(got[stratum][key] - m[key]) <= 1e-6, (stratum, key)
    assert want["polar"]["AP50"] > 0.1  # the jittered GTs are found


def _variant(rng, overrides, seeds, diverged=False):
    if diverged:
        return {"overrides": overrides,
                "seeds": {str(s): {"error": "loss is NaN at step 20"}
                          for s in seeds},
                "AP50_mean": None, "mAP_mean": None}
    out = {"overrides": overrides, "seeds": {}}
    for s in seeds:
        ap = float(rng.uniform(0.05, 0.6))
        out["seeds"][str(s)] = {
            "AP50": ap, "mAP": ap / 2, "AP75": ap / 3, "n_images": 100,
            "strata": {st: {"AP50": float(rng.uniform(0, 0.6)),
                            "mAP": 0.1, "n_images": 30}
                       for st in ("polar", "seam", "body")},
            "train_seconds": 301.5}
    out["AP50_mean"] = float(np.mean([m["AP50"]
                                      for m in out["seeds"].values()]))
    out["mAP_mean"] = float(np.mean([m["mAP"] for m in out["seeds"].values()]))
    return out


def _reports(seed: int):
    rng = np.random.default_rng(seed)
    names = [(n, o) for n, o in jax_study.VARIANTS]

    def family(seeds, diverged=()):
        return {name: _variant(rng, o, seeds, name in diverged)
                for name, o in names}

    def report(variants, fams, seeds):
        return {"base_config": "configs/sph_retinanet_r18_fpn_24e_"
                               "spherebench.py",
                "dataset": {"root": "d", "box_version": 4, "n_train": 500,
                            "n_val": 100, "num_classes": 12,
                            "img_size": [256, 512]},
                "seeds": seeds, "max_epochs": 24, "eval_backend": "unbiased",
                "variants": variants, "families": fams}

    retina0 = family([0, 1], diverged=("kent",))
    fcos0 = {"l1": _variant(rng, ["a"], [0]), "ciou": _variant(rng, [], [0])}
    base = report(retina0, {
        "retinanet": {"base_config": "r.py", "variants": retina0,
                      "orderings": {}},
        "fcos": {"base_config": "f.py", "variants": fcos0,
                 "orderings": {}}}, [0, 1])
    retina1 = family([1, 2], diverged=("kent",))
    retina1["l1"]["overrides"] = ["changed"]
    new = report(retina1, {"retinanet": {"base_config": "r.py",
                                         "variants": retina1,
                                         "orderings": {}}}, [1, 2])
    return base, new


def test_report_functions_equal_the_jax_tools(emptied_tmp_path):
    base, new = _reports(seed=4)
    for fam in base["families"].values():
        assert port._orderings(fam["variants"]) \
            == jax_study._orderings(fam["variants"])
    got = port.merge_reports(base, new)
    want = jax_study.merge_reports(base, new)
    assert got == want and got["orderings"]
    paths = {}
    for name, mod in (("port", port), ("jax", jax_study)):
        d = emptied_tmp_path / name
        d.mkdir()
        (d / "ROOT_CAUSE.md").write_text("## Root cause\n\nmeasured.\n")
        mod.write_markdown(got, str(d / "AP_STUDY.md"))
        paths[name] = (d / "AP_STUDY.md").read_text()
    cited = re.sub(r"\(/\S+/README\.md:", "(reference README.md:",
                   paths["jax"])
    assert cited != paths["jax"]
    assert paths["port"] == cited
    assert "## Detector family: fcos" in paths["port"]
    assert "(loss is NaN at step 20)" in paths["port"]


def test_quick_study_on_the_cpu(emptied_tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    calls = []
    plain = sph2pob_iou.sph2pob_iou_pairwise_plain

    def counted(boxes1, boxes2):
        calls.append((tuple(boxes1.shape), tuple(boxes2.shape)))
        return plain(boxes1, boxes2)

    monkeypatch.setattr(sph2pob_iou, "sph2pob_iou_pairwise_plain", counted)
    out = emptied_tmp_path / "out"
    report = port.run_study(out_dir=str(out), seeds=[0], max_epochs=1,
                            quick=True, variants=[("ciou", [])],
                            device="cpu")
    assert calls == [((192, 4), (6138, 4))] * 3  # 24 images at batch 8
    assert report["dataset"] == {
        "root": str(out / "sphere_bench"), "box_version": 4, "n_train": 24,
        "n_val": 12, "num_classes": 4, "img_size": [128, 256]}
    assert set(report) == {"base_config", "dataset", "seeds", "max_epochs",
                           "eval_backend", "variants", "families"}
    s = report["variants"]["ciou"]["seeds"]["0"]
    assert set(s) == {"AP50", "mAP", "AP75", "n_images", "strata",
                      "train_seconds"}
    assert s["n_images"] == 12 and 0.0 <= s["AP50"] <= 1.0
    assert s["strata"] and all(set(m) == {"AP50", "mAP", "n_images"}
                               for m in s["strata"].values())
    assert report["families"]["retinanet"]["variants"] == report["variants"]
    with open(out / "report.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert (out / "AP_STUDY.md").exists()
    with np.load(out / "ciou_s0" / "eval_arrays.npz") as a:
        assert a["boxes"].shape[0] == 12 and a["img_id"].min() == 1


def test_diagnose_equals_the_jax_tools(emptied_tmp_path):
    path = str(emptied_tmp_path / "eval_arrays.npz")
    np.savez_compressed(path, **_eval_arrays(seed=7))
    got = port_diag.diagnose(path, 0.3, STRATA_BY_IMG, device="cpu")
    want = jax_diag.diagnose(path, 0.3, STRATA_BY_IMG)
    assert list(got) == list(want) == ["all", "polar", "body"]
    for bucket, w in want.items():
        assert list(got[bucket]) == list(w)
        for key, value in w.items():
            if isinstance(value, int):
                assert got[bucket][key] == value, (bucket, key)
            else:
                assert abs(got[bucket][key] - value) <= 1e-4, (bucket, key)
    assert want["all"]["hits"] > 0 and want["all"]["halluc"] > 0

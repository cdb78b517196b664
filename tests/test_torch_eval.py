"""The port's dataset reader, spherical-mAP evaluation and evaluation loop
against the JAX package's, on the CPU.

- ``SphCocoDataset``: item by item equal on a COCO JSON written by
  ``tests/utils/synthetic_coco.py`` with crowd annotations and an empty
  image added, read as 4-dof and as 5-dof, empty images kept and dropped;
- ``build_datasets``: the same batches for all three splits (``array_equal``),
  both sides decoding through PIL (the native C++ decoders, where built,
  normalise with another rounding); ``transfer_colorspace`` ``yuv420`` and
  ``auto`` build, shards raise;
- ``eval_spherical_map`` / ``eval_voc_map``: 1e-12 where the JAX side's
  ``_pairwise_iou_np`` is given the port's IoUs (the rest is float64 numpy
  on both sides); 1e-6 with each side's own IoUs, on inputs whose IoUs and
  IoFs are all >= 1e-3 from every threshold, so that the two IoU
  implementations (1e-7 apart) take the same matching decisions;
- ``_greedy_match_image``: equal;
- ``evaluate_dataset`` on one loader, Flax weights carried across with
  ``from_flax``, RetinaNet (RBFoV, NMS through the fused IoU's plain version)
  and FCOS (planar NMS): validity and labels equal, scores 1e-4, boxes 5e-3
  degrees (1e-4 in the regression deltas times the ~50 degrees of a large
  anchor's field of view), metrics equal. The seeded weights give continuous
  scores, so no two candidates tie (C2).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.data import SphCocoDataset as JaxCocoDataset
from sph_retina_tpu.engine import builder as jbuilder
from sph_retina_tpu.engine import eval as jeval
from sph_retina_tpu.engine import evaluator as jevaluator
from sph_retina_tpu.engine.zoo import get_family as jax_get_family
from sph_retina_tpu_torch.data import SphCocoDataset
from sph_retina_tpu_torch.engine import builder as tbuilder
from sph_retina_tpu_torch.engine import eval as teval
from sph_retina_tpu_torch.engine import evaluator as tevaluator
from sph_retina_tpu_torch.engine.zoo import get_family
from sph_retina_tpu_torch.models.from_flax import load_flax_variables
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config

from test_torch_model import randomize

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from utils.synthetic_coco import write_synthetic_coco  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 128
BACKEND = "sph2pob_efficient"
CPU = torch.device("cpu")


@pytest.fixture
def pil_decoding(monkeypatch):
    """Both pipelines' PIL path, not their native decoders (whose fp32
    output normalises with another rounding)."""
    from sph_retina_tpu.data import native_loader
    from sph_retina_tpu_torch.data import native_loader as port_native

    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A 3-class COCO set of 8 images, plus two crowd annotations and one
    image with no annotation at all."""
    root = tmp_path_factory.mktemp("coco")
    ann, img_dir = write_synthetic_coco(str(root), n_images=8, num_classes=3,
                                        img_size=(H, W))
    with open(ann) as f:
        data = json.load(f)
    data["annotations"] += [
        {"id": 900, "image_id": 2, "category_id": 2, "iscrowd": 1,
         "bbox": [180.0, 90.0, 40.0, 30.0], "area": 1.0},
        {"id": 901, "image_id": 5, "category_id": 3, "iscrowd": 1,
         "bbox": [60.0, 80.0, 30.0, 50.0], "area": 1.0},
    ]
    data["images"].append({"id": 99, "file_name": data["images"][0][
        "file_name"], "width": W, "height": H})
    with open(ann, "w") as f:
        json.dump(data, f)
    return ann, img_dir + "/"


@pytest.mark.parametrize("box_version", [4, 5])
@pytest.mark.parametrize("filter_empty", [True, False])
def test_coco_dataset_equals_the_jax_packages(coco, box_version,
                                              filter_empty):
    ann, img_dir = coco
    kw = dict(ann_file=ann, img_prefix=img_dir, box_version=box_version,
              filter_empty=filter_empty)
    got, want = SphCocoDataset(**kw), JaxCocoDataset(**kw)
    assert got.classes == want.classes == ("class_0", "class_1", "class_2")
    assert got.num_classes == want.num_classes == 3
    assert len(got) == len(want) == (8 if filter_empty else 9)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k
        assert g["boxes"].shape[1] == box_version
    crowd = [i for i in range(len(got)) if len(got[i]["ignore_boxes"])]
    assert len(crowd) == 2
    if box_version == 5:  # 4-dof boxes read as 5-dof: gamma 0
        assert not got[crowd[0]]["ignore_boxes"][:, 4].any()


def _cfg(ann, img_dir, config="sph_rotated_retinanet_r50_fpn_120e_pandora.py",
         extra=()):
    split = {"ann_file": ann, "img_prefix": img_dir}
    cfg = apply_overrides(load_config(os.path.join(REPO, "configs", config)), [
        "model.backbone.depth=18", "img_size=(64,128)", "bf16=False",
        "data.samples_per_gpu=3", "data.workers_per_gpu=2", "data.max_gt=8",
        *extra])
    cfg["model"]["num_classes"] = 3
    for s in ("train", "val", "test"):
        cfg["data"][s] = dict(split)
    cfg["seed"] = 3
    return cfg


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_build_datasets_gives_the_jax_packages_batches(coco, split,
                                                      pil_decoding):
    cfg = _cfg(*coco)
    tds, tloader = tbuilder.build_datasets(cfg, split)
    jds, jloader = jbuilder.build_datasets(cfg, split)
    assert len(tds) == len(jds) and len(tloader) == len(jloader)
    assert (tloader.shuffle, tloader.drop_last) == (split == "train",) * 2
    assert tloader.pipeline.flip_ratio == (0.5 if split == "train" else 0.0)
    for epoch in (0, 1):
        got = list(tloader.epoch(epoch))
        want = list(jloader.epoch(epoch))
        assert len(got) == len(want) == (2 if split == "train" else 3)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_build_datasets_refuses_what_is_not_ported(coco, monkeypatch):
    """``auto`` and ``yuv420`` build (``auto`` resolved by the policy, here
    with its probes replaced: a link that binds gives ``yuv420``, no card
    gives ``rgb``); shards still raise."""
    from sph_retina_tpu_torch.data import policy

    cfg = _cfg(*coco)
    cfg["data"]["transfer_colorspace"] = "yuv420"
    _, loader = tbuilder.build_datasets(cfg, "val")
    assert loader.pipeline.transfer_colorspace == "yuv420"
    assert loader.pipeline.normalize_on_device  # forced by yuv420
    assert next(loader.epoch(0))["images"].shape == (3, H * 3 // 2, W)
    cfg["data"]["transfer_colorspace"] = "auto"
    monkeypatch.setattr(policy, "_probe_host_rates",
                        lambda img_size: {"rgb": 500.0, "yuv420": 400.0})
    monkeypatch.setattr(policy, "_probe_link_bytes_per_sec", lambda: 1e6)
    _, loader = tbuilder.build_datasets(cfg, "val")
    assert loader.pipeline.transfer_colorspace == "yuv420"

    def no_card():
        raise RuntimeError("no CUDA device to probe the link to")

    monkeypatch.setattr(policy, "_probe_link_bytes_per_sec", no_card)
    with pytest.warns(UserWarning, match="using 'rgb'"):
        _, loader = tbuilder.build_datasets(cfg, "val")
    assert loader.pipeline.transfer_colorspace == "rgb"
    cfg["data"]["transfer_colorspace"] = "rgb"
    with pytest.raises(NotImplementedError, match="shards"):
        tbuilder.build_datasets(cfg, "val", num_shards=2, shard_id=1)


def _boxes(rng, n, d):
    b = np.stack([rng.uniform(20, 340, n), rng.uniform(40, 140, n),
                  rng.uniform(15, 60, n), rng.uniform(15, 60, n)], 1)
    if d == 5:
        b = np.concatenate([b, rng.uniform(-40, 40, (n, 1))], 1)
    return b.astype(np.float32)


def detections(seed, d, n_imgs=6, classes=4):
    """Per image: gts, crowd regions, and detections that are jittered gts
    (some with the wrong class), duplicates of those, detections on the
    crowd regions and random boxes, with seeded continuous scores."""
    rng = np.random.default_rng(seed)
    dets, anns = [], []
    for i in range(n_imgs):
        g = int(rng.integers(1, 6))
        gt = _boxes(rng, g, d)
        gl = rng.integers(0, classes, g).astype(np.int32)
        n_ig = int(rng.integers(0, 3)) if i % 2 else 0
        ig = _boxes(rng, n_ig, d)
        il = rng.integers(0, classes, n_ig).astype(np.int32)
        jit = gt + rng.normal(0, 3, gt.shape).astype(np.float32)
        jl = np.where(rng.random(g) < 0.2, (gl + 1) % classes, gl)
        dup = jit[: g // 2] + rng.normal(0, 1, (g // 2, d)).astype(np.float32)
        on_ig = ig + rng.normal(0, 2, ig.shape).astype(np.float32)
        rnd = _boxes(rng, int(rng.integers(0, 5)), d)
        boxes = np.concatenate([jit, dup, on_ig, rnd]).astype(np.float32)
        labels = np.concatenate([
            jl, jl[: g // 2], il,
            rng.integers(0, classes, len(rnd))]).astype(np.int32)
        scores = rng.uniform(0.05, 1.0, len(boxes)).astype(np.float32)
        dets.append((boxes, scores, labels))
        anns.append({"boxes": gt, "labels": gl, "ignore_boxes": ig,
                     "ignore_labels": il})
    # an image without detections and one without gts
    dets.append((np.zeros((0, d), np.float32), np.zeros(0, np.float32),
                 np.zeros(0, np.int32)))
    anns.append({"boxes": _boxes(rng, 2, d),
                 "labels": np.array([0, 1], np.int32)})
    dets.append(dets[0])
    anns.append({"boxes": np.zeros((0, d), np.float32),
                 "labels": np.zeros(0, np.int32)})
    return dets, anns, classes


def _port_iou(det_boxes, gt_boxes, backend, max_det=128, max_gt=64):
    return teval._pairwise_iou_np(det_boxes, gt_boxes, backend, device=CPU)


def _same_coco(got, want, atol):
    for k in ("mAP", "AP50", "AP75"):
        if want[k] is None:  # not among the thresholds
            assert got[k] is None, k
        else:
            np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0)
    np.testing.assert_allclose(got["per_class"], want["per_class"],
                               atol=atol, rtol=0)
    np.testing.assert_array_equal(got["valid_classes"], want["valid_classes"])


def _same_voc(got, want, atol):
    np.testing.assert_allclose(got["mAP"], want["mAP"], atol=atol, rtol=0)
    assert len(got["per_class"]) == len(want["per_class"])
    for g, w in zip(got["per_class"], want["per_class"]):
        assert (g["num_gts"], g["num_dets"]) == (w["num_gts"], w["num_dets"])
        for k in ("recall", "precision", "ap"):
            np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0)


@pytest.mark.parametrize("d", [4, 5])
def test_eval_metrics_equal_the_jax_packages_on_the_same_ious(d, monkeypatch):
    dets, anns, classes = detections(seed=d, d=d)
    monkeypatch.setattr(jeval, "_pairwise_iou_np", _port_iou)
    got = teval.eval_spherical_map(dets, anns, classes, backend=BACKEND,
                                   device="cpu")
    want = jeval.eval_spherical_map(dets, anns, classes, backend=BACKEND)
    _same_coco(got, want, 1e-12)
    assert 0.05 < got["AP50"] < 0.99 and got["mAP"] < got["AP50"]
    for thr in (0.5, 0.3):
        got = teval.eval_voc_map(dets, anns, classes, iou_thr=thr,
                                 backend=BACKEND, device="cpu")
        want = jeval.eval_voc_map(dets, anns, classes, iou_thr=thr,
                                  backend=BACKEND)
        _same_voc(got, want, 1e-12)
        assert 0.05 < got["mAP"] < 0.99
    # fewer thresholds and detections per image: the same options
    kw = dict(iou_thrs=(0.5, 0.7), max_dets=3, backend=BACKEND)
    _same_coco(teval.eval_spherical_map(dets, anns, classes, device="cpu",
                                        **kw),
               jeval.eval_spherical_map(dets, anns, classes, **kw), 1e-12)


def _away_from_thresholds(dets, anns, margin=1e-3):
    """Drop every detection whose IoU with a gt or a crowd region, or IoF
    with a crowd region, lies within ``margin`` of a COCO threshold."""
    thrs = np.asarray(teval.COCO_IOU_THRS)
    out = []
    for (boxes, scores, labels), ann in zip(dets, anns):
        ig = np.asarray(ann.get("ignore_boxes", np.zeros((0, boxes.shape[1]))),
                        np.float32).reshape(-1, boxes.shape[1])
        both = np.concatenate([np.asarray(ann["boxes"]).reshape(
            -1, boxes.shape[1]), ig])
        iou = teval._pairwise_iou_np(boxes, both, BACKEND, device=CPU)
        iof = teval._pairwise_iof_np(boxes, ig, BACKEND, device=CPU)
        vals = np.concatenate([iou, iof], 1)
        near = (np.abs(vals[:, :, None] - thrs) < margin).any(axis=(1, 2))
        out.append((boxes[~near], scores[~near], labels[~near]))
    return out


def test_eval_metrics_equal_the_jax_packages_with_their_own_ious():
    d = 5
    dets, anns, classes = detections(seed=7, d=d)
    dets = _away_from_thresholds(dets, anns)
    assert sum(len(b) for b, _, _ in dets) > 30
    got = teval.eval_spherical_map(dets, anns, classes, backend=BACKEND,
                                   device="cpu")
    want = jeval.eval_spherical_map(dets, anns, classes, backend=BACKEND)
    _same_coco(got, want, 1e-6)
    assert got["AP50"] > 0.05
    got = teval.eval_voc_map(dets, anns, classes, backend=BACKEND,
                             device="cpu")
    want = jeval.eval_voc_map(dets, anns, classes, backend=BACKEND)
    _same_voc(got, want, 1e-6)


def test_the_matcher_takes_sph_overlaps_not_the_fused_kernel(monkeypatch):
    """The unfused Sph2Pob, as in the JAX package (the fused one differs by
    up to 3.3e-4 at D=5, ROADMAP C7)."""
    from sph_retina_tpu_torch.iou import api

    calls = []
    real = api.sph_overlaps
    monkeypatch.setattr(teval, "sph_overlaps", lambda a, b, backend: (
        calls.append((tuple(a.shape), tuple(b.shape), backend, a.device,
                      a.dtype)) or real(a, b, backend)))
    dets, anns, classes = detections(seed=3, d=5, n_imgs=3)
    teval.eval_spherical_map(dets, anns, classes, backend=BACKEND,
                             device="cpu")
    # one matrix an image with detections and boxes: gts and crowd together
    assert len(calls) == 3
    n_ig = [len(a["ignore_boxes"]) for a in anns[:3]]
    assert [c[1][0] for c in calls] == [
        len(a["boxes"]) + n for a, n in zip(anns[:3], n_ig)]
    assert {c[2:] for c in calls} == {(BACKEND, CPU, torch.float32)}


def test_greedy_match_image_equals_the_jax_packages():
    rng = np.random.default_rng(5)
    thrs = np.asarray(teval.COCO_IOU_THRS)
    for d, g in ((7, 4), (5, 0), (0, 3), (12, 12)):
        ious = rng.uniform(0, 1, (d, g))
        ious[ious < 0.3] = 0.0
        iof = rng.uniform(0, 1, d)
        got = teval._greedy_match_image(ious, iof, thrs)
        want = jeval._greedy_match_image(ious, iof, thrs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_eval_on_the_card_is_the_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    box = np.array([[90.0, 90.0, 30.0, 30.0]], np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        teval._pairwise_iou_np(box, box, BACKEND)


FAMILIES = {
    "retinanet": ("sph_rotated_retinanet_r50_fpn_120e_pandora.py", 5),
    "fcos": ("sph_fcos_r50_fpn_120e_indoor360.py", 4),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evaluate_dataset_equals_the_jax_packages(coco, family, monkeypatch,
                                                  pil_decoding):
    config, d = FAMILIES[family]
    ann, img_dir = coco
    cfg = _cfg(ann, img_dir, config)
    cfg["model"]["box_version"] = d
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
    tmodel.train()  # evaluate_dataset switches to eval() and back

    _, tloader = tbuilder.build_datasets(cfg, "val")
    _, jloader = jbuilder.build_datasets(cfg, "val")
    monkeypatch.setattr(jeval, "_pairwise_iou_np", _port_iou)
    # seeded weights place no box within IoU 0.5 of a gt: low thresholds
    # as well, so that the metrics compared are not all 0
    thrs = (0.05, 0.1, 0.2, 0.5)
    want, jraw = jevaluator.evaluate_dataset(
        jmodel, jdet, {"params": params, "batch_stats": stats}, jloader,
        iou_thrs=thrs, predict=jax.jit(jfam.predict_fn(jmodel, jdet)),
        return_raw=True)
    got, traw = tevaluator.evaluate_dataset(
        tmodel, tdet, tloader, iou_thrs=thrs,
        predict=tfam.predict_fn(tmodel, tdet), return_raw=True)
    assert tmodel.training

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


def test_evaluate_dataset_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="distributed"):
        tevaluator.evaluate_dataset(None, None, None, distributed=True)

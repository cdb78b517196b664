"""The production input path as a slice, on the CPU, against the JAX
package: a COCO-style set (``tests/utils/synthetic_coco.py``) through
``build_datasets`` with ``transfer_colorspace`` ``yuv420`` and ``auto``
(its probes replaced), one train step of the rotated R18 RetinaNet on such
an I420 batch, and ``evaluate_dataset`` on an I420 val split.

- batches: I420 ``(B, H*3/2, W)`` uint8, bitwise the JAX package's (both
  decode through PIL: the JAX package's native decoder would build in
  ``native/``);
- the train step (``make_generic_train_step``, Flax weights carried across
  with ``from_flax``): losses within 1e-4 (total 2e-4), gradients rtol 1e-3
  / atol 1e-5, the tolerances of ``tests/test_torch_train_slice.py``; both
  assigners see the port's overlaps (C3);
- the evaluation: the metrics within 1e-6 of the JAX package's, the JAX
  side's matcher given the port's IoUs as in ``tests/test_torch_eval.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.data import policy as jpolicy
from sph_retina_tpu.engine import builder as jbuilder
from sph_retina_tpu.engine import eval as jeval
from sph_retina_tpu.engine import evaluator as jevaluator
from sph_retina_tpu.engine import train as jtrain
from sph_retina_tpu.engine.zoo import get_family as jax_get_family
from sph_retina_tpu.models import single_stage as jss
from sph_retina_tpu_torch.data import policy
from sph_retina_tpu_torch.engine import builder as tbuilder
from sph_retina_tpu_torch.engine import eval as teval
from sph_retina_tpu_torch.engine import evaluator as tevaluator
from sph_retina_tpu_torch.engine.train import SGDOptimizer
from sph_retina_tpu_torch.engine.zoo import get_family, make_generic_train_step
from sph_retina_tpu_torch.models.from_flax import load_flax_variables, to_flax
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config

from test_torch_assign_loss import port_iou_callback
from test_torch_model import randomize

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from utils.synthetic_coco import write_synthetic_coco  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, CLASSES = 64, 128, 3
CPU = torch.device("cpu")
PROBES = {"host": lambda img_size: {"rgb": 300.0, "yuv420": 250.0},
          "link": lambda: 2e6}  # a link that binds: 'auto' picks yuv420


@pytest.fixture(autouse=True)
def pil_and_probes(monkeypatch):
    """Both pipelines decode through PIL; both policies see the same
    injected probes."""
    from sph_retina_tpu.data import native_loader
    from sph_retina_tpu_torch.data import native_loader as port_native

    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)
    for mod in (policy, jpolicy):
        monkeypatch.setattr(mod, "_probe_host_rates", PROBES["host"])
        monkeypatch.setattr(mod, "_probe_link_bytes_per_sec", PROBES["link"])


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    ann, img_dir = write_synthetic_coco(str(root), n_images=6,
                                        num_classes=CLASSES, img_size=(H, W),
                                        box_version=5)
    return ann, img_dir + "/"


def _cfg(coco, colorspace):
    ann, img_dir = coco
    cfg = apply_overrides(load_config(os.path.join(
        REPO, "configs", "sph_rotated_retinanet_r50_fpn_120e_pandora.py")), [
        "model.backbone.depth=18", "img_size=(64,128)", "bf16=False",
        "data.samples_per_gpu=2", "data.workers_per_gpu=2", "data.max_gt=8",
        f"data.transfer_colorspace={colorspace}"])
    cfg["model"]["num_classes"] = CLASSES
    for s in ("train", "val", "test"):
        cfg["data"][s] = {"ann_file": ann, "img_prefix": img_dir}
    cfg["seed"] = 3
    return cfg


@pytest.fixture(scope="module")
def flax_retinanet():
    from sph_retina_tpu.models import SphRetinaNet as FlaxRetinaNet

    flax_model = FlaxRetinaNet(num_classes=CLASSES, box_version=5, depth=18,
                               dtype=jnp.float32)
    variables = flax_model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, H, W, 3)))
    return flax_model, jax.device_get(variables)


def _seeded(variables, seed):
    rng = np.random.default_rng(seed)
    return (randomize(variables["params"], rng),
            randomize(variables["batch_stats"], rng))


@pytest.fixture(scope="module")
def weights(flax_retinanet):
    """Seeded Flax weights of the rotated R18 RetinaNet, damped as in the
    training slice's test so that the gradients stay moderate."""
    flax_model, variables = flax_retinanet
    params, stats = _seeded(variables, 0)
    for name, block in params["backbone"].items():
        if name.startswith("layer"):
            for bn in ("bn2", "downsample_bn"):
                if bn in block:
                    block[bn]["scale"] = block[bn]["scale"] * np.float32(0.3)
    params["bbox_head"]["retina_cls"]["bias"] = np.full(
        params["bbox_head"]["retina_cls"]["bias"].shape, -4.59512, np.float32)
    return flax_model, params, stats


@pytest.mark.parametrize("colorspace", ["yuv420", "auto"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_build_datasets_gives_the_jax_packages_i420_batches(coco, colorspace,
                                                           split):
    cfg = _cfg(coco, colorspace)
    _, tloader = tbuilder.build_datasets(cfg, split)
    _, jloader = jbuilder.build_datasets(cfg, split)
    assert tloader.pipeline.transfer_colorspace == "yuv420"
    assert tloader.pipeline.normalize_on_device
    got, want = list(tloader.epoch(1)), list(jloader.epoch(1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["images"].shape == (2, H * 3 // 2, W)
        assert g["images"].dtype == np.uint8
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


def test_a_train_step_on_an_i420_batch_equals_the_jax_step(coco, weights,
                                                          monkeypatch):
    """The trainer's step (``make_generic_train_step``: the I420 batch
    converted and normalised, then the loss, backward and the optimiser)
    against the JAX package's loss and gradient on the same host batch
    through its ``maybe_normalize_images``."""
    flax_model, params, stats = weights
    cfg = _cfg(coco, "yuv420")
    _, loader = tbuilder.build_datasets(cfg, "train")
    host = next(loader.epoch(0))
    assert host["images"].shape == (2, H * 3 // 2, W)

    family = get_family(cfg)
    model, tcfg = family.build(cfg)
    load_flax_variables(model, params, stats)
    optimizer = SGDOptimizer(model, lambda count: 0.01, weight_decay=0.0)
    step = make_generic_train_step(family, model, tcfg, optimizer)
    metrics = step({k: torch.from_numpy(v) for k, v in host.items()
                    if k != "img_id"})
    grads, no_stats = to_flax({n: p.grad for n, p in model.named_parameters()})
    assert no_stats == {}

    _, jcfg = jax_get_family(cfg).build(cfg)
    anchors = jcfg.flat_anchors()
    monkeypatch.setattr(jss, "_batch_pairwise_iou",
                        port_iou_callback(tcfg.flat_anchors()))

    def loss(p, batch):
        images = jtrain.maybe_normalize_images(batch["images"])
        cls, reg = flax_model.apply({"params": p, "batch_stats": stats},
                                    images)
        losses = jss.retina_loss(jcfg, cls, reg, anchors, batch["gt_boxes"],
                                 batch["gt_labels"], batch["gt_mask"])
        return jtrain.total_loss(losses), losses

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params, {k: jnp.asarray(host[k]) for k in (
            "images", "gt_boxes", "gt_labels", "gt_mask")})
    assert set(jlosses) == {"loss_cls", "loss_bbox"}
    for k in jlosses:
        np.testing.assert_allclose(float(metrics[k]), float(jlosses[k]),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(metrics["loss"]), float(jtotal),
                               atol=2e-4, rtol=0)
    assert float(metrics["loss_bbox"]) > 0
    got, want = dict(_leaves(grads)), dict(_leaves(jax.device_get(jgrads)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def _port_iou(det_boxes, gt_boxes, backend, max_det=128, max_gt=64):
    return teval._pairwise_iou_np(det_boxes, gt_boxes, backend, device=CPU)


def test_evaluate_dataset_on_an_i420_val_split_equals_the_jax_packages(
        coco, flax_retinanet, monkeypatch):
    """Seeded weights as in ``tests/test_torch_eval.py`` (not damped: they
    give detections above the score threshold)."""
    flax_model, variables = flax_retinanet
    params, stats = _seeded(variables, 1)
    cfg = _cfg(coco, "yuv420")
    family = get_family(cfg)
    model, tdet = family.build(cfg)
    load_flax_variables(model, params, stats)
    jfam = jax_get_family(cfg)
    _, jdet = jfam.build(cfg)
    jdet = jdet.__class__(**{**jdet.__dict__, "approx_topk": False})
    _, tloader = tbuilder.build_datasets(cfg, "val")
    _, jloader = jbuilder.build_datasets(cfg, "val")
    monkeypatch.setattr(jeval, "_pairwise_iou_np", _port_iou)
    thrs = (0.05, 0.1, 0.2, 0.5)  # seeded weights: low thresholds as well
    want = jevaluator.evaluate_dataset(
        flax_model, jdet, {"params": params, "batch_stats": stats}, jloader,
        iou_thrs=thrs, predict=jax.jit(jfam.predict_fn(flax_model, jdet)))
    got = tevaluator.evaluate_dataset(model, tdet, tloader, iou_thrs=thrs,
                                      predict=family.predict_fn(model, tdet))
    assert got["n_images"] == want["n_images"] == 6
    for k in ("mAP", "AP50", "AP75"):
        if want[k] is None:  # not among the thresholds
            assert got[k] is None, k
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["per_class"], want["per_class"],
                               atol=1e-6, rtol=0)
    assert got["mAP"] > 0

"""Gradient checkpointing of the PyTorch port's backbones
(``model.backbone.remat``), on the CPU.

The JAX package puts each residual block (``models/resnet.py``) and SSD's
whole VGG trunk (``models/ssd.py``) under ``nn.remat`` when the config says
``model.backbone.remat=True``. The port checkpoints the same pieces with
``torch.utils.checkpoint`` in a training forward with gradients:

- for R18 RetinaNet, a ResNeXt-50 32x4d RetinaNet, R18 FCOS, SSD-VGG16 and
  R18 Faster R-CNN at 64x128, fp32, the loss and every gradient with
  ``remat`` equal those without it bitwise (the recomputation runs the same
  CPU kernels on the same inputs), the frozen stem and stage 1 get no
  gradient in either, and the checkpointed pieces are the JAX package's;
- every config in ``configs/`` with ``model.backbone.remat`` on and off
  builds a port model with ``remat`` set where the JAX model has it;
- the state-dict keys do not change;
- in eval mode and under ``no_grad`` (the path of ``PredictModule`` and of
  ``torch.export``) nothing is checkpointed, and a remat model predicts
  what a plain one does.
"""

import copy
import glob
import os

import numpy as np
import pytest
import torch

from sph_retina_tpu.engine import zoo as jzoo
from sph_retina_tpu_torch.engine import zoo as tzoo
from sph_retina_tpu_torch.engine.builder import build_tx
from sph_retina_tpu_torch.geometry import generate_boxes
from sph_retina_tpu_torch.models import resnet, ssd
from sph_retina_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 3
# model dict (without num_classes), pieces checkpointed in one forward
FAMILIES = {
    "retinanet_r18": (dict(type="SphRetinaNet", backbone=dict(depth=18)), 8),
    "resnext50_32x4d": (dict(type="SphRetinaNet", backbone=dict(
        depth=50, groups=32, base_width=4)), 16),
    "fcos_r18": (dict(type="SphFCOS", backbone=dict(depth=18)), 8),
    "ssd_vgg16": (dict(type="SphSSD"), 1),
    "faster_rcnn_r18": (dict(type="SphFasterRCNN", backbone=dict(depth=18)),
                        8),
}


def make_cfg(name: str, remat: bool) -> dict:
    model = copy.deepcopy(FAMILIES[name][0])
    model.setdefault("backbone", {})["remat"] = remat
    return {"model": dict(model, num_classes=NUM_CLASSES, box_version=4),
            "img_size": (64, 128), "bf16": False}


def make_batch(b: int = 2) -> dict:
    rng = np.random.default_rng(0)
    mask = np.zeros((b, 8), bool)
    mask[:, :5] = True
    return {
        "images": torch.from_numpy(
            rng.normal(0.0, 1.0, (b, 64, 128, 3)).astype(np.float32)),
        "gt_boxes": torch.from_numpy(np.stack([
            generate_boxes(8, 4, fov_range=(20.0, 60.0), seed=i)
            for i in range(b)])),
        "gt_labels": torch.from_numpy(
            rng.integers(0, NUM_CLASSES, (b, 8)).astype(np.int32)),
        "gt_mask": torch.from_numpy(mask),
    }


def build(cfg: dict):
    family = tzoo.get_family(cfg)
    model, det_cfg = family.build(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return family, model, det_cfg


@pytest.fixture
def checkpoints(monkeypatch):
    """Counts the calls of ``torch.utils.checkpoint.checkpoint`` by the
    ResNet and SSD modules."""
    calls = []
    for module in (resnet, ssd):
        real = module.checkpoint

        def counting(fn, *args, _real=real, **kwargs):
            calls.append(type(fn).__name__)
            return _real(fn, *args, **kwargs)

        monkeypatch.setattr(module, "checkpoint", counting)
    return calls


def loss_and_grads(cfg: dict, batch: dict):
    family, model, det_cfg = build(cfg)
    build_tx(cfg, model, 1)  # frozen_stages=1: the stem and stage 1
    total, losses = family.loss_fn(model, det_cfg)(
        batch, torch.Generator().manual_seed(0))
    total.backward()
    return ({k: v.detach() for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters()})


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_losses_and_gradients_equal_without_remat(name, checkpoints):
    batch = make_batch()
    want_losses, want_grads = loss_and_grads(make_cfg(name, False), batch)
    assert checkpoints == []
    got_losses, got_grads = loss_and_grads(make_cfg(name, True), batch)
    kind = "SSDVGG" if name.startswith("ssd") else \
        "Bottleneck" if name.startswith("resnext") else "BasicBlock"
    assert checkpoints == [kind] * FAMILIES[name][1]

    assert got_losses.keys() == want_losses.keys()
    for k in want_losses:  # bitwise
        assert torch.equal(got_losses[k], want_losses[k]), k
    assert all(torch.isfinite(v) for v in want_losses.values())
    frozen = [n for n, g in want_grads.items() if g is None]
    assert frozen and all(n.startswith("backbone.") for n in frozen)
    assert [n for n, g in got_grads.items() if g is None] == frozen
    for n, g in want_grads.items():
        if g is not None:
            assert torch.equal(got_grads[n], g), n


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(REPO, "configs", "*.py"))), ids=os.path.basename)
def test_remat_is_set_where_the_jax_model_sets_it(path, remat):
    cfg = tconfig.apply_overrides(tconfig.load_config(path),
                                  [f"model.backbone.remat={remat}"])
    jmodel, _ = jzoo.get_family(cfg).build(cfg)
    with torch.device("meta"):
        tmodel, _ = tzoo.get_family(cfg).build(cfg)
    port = tmodel.remat if isinstance(tmodel, ssd.SphSSD) \
        else tmodel.backbone.remat
    assert port is jmodel.remat is remat


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_state_dict_keys_do_not_change(name):
    with torch.device("meta"):
        plain = tzoo.get_family(make_cfg(name, False)).build(
            make_cfg(name, False))[0]
        remat = tzoo.get_family(make_cfg(name, True)).build(
            make_cfg(name, True))[0]
    assert list(remat.state_dict()) == list(plain.state_dict())


@pytest.mark.parametrize("name", ["retinanet_r18", "ssd_vgg16",
                                  "faster_rcnn_r18"])
def test_predict_checkpoints_nothing(name, checkpoints):
    """``predict_fn`` (``PredictModule`` under ``no_grad``, what
    ``torch.export`` traces) in training mode and in eval mode: no
    checkpoint, the plain model's results."""
    images = make_batch(1)["images"]
    _, plain, det_cfg = build(make_cfg(name, False))
    family, remat, _ = build(make_cfg(name, True))
    for training in (True, False):
        plain.train(training)
        remat.train(training)
        want = family.predict_fn(plain, det_cfg)(images)
        got = family.predict_fn(remat, det_cfg)(images)
        for field, g, w in zip(want._fields, got, want):
            assert torch.equal(g, w), (training, field)
    assert checkpoints == []
    with torch.no_grad():
        remat.train()(images)
    assert checkpoints == []

"""Pretrained backbones in the port: the torchvision porters, ``load_backbone``
and ``train.py --load-backbone``, against the JAX package's porters and the
torch modules' own forwards.

There is no torchvision here (and none on the card's host): the tests build
torch modules with torchvision's exact layout and key names (ResNet-18,
ResNet-50, ResNeXt-50 32x4d, the VGG16 ``features``), randomise every weight
and the batch norms' statistics (variance > 0), and save their
``state_dict`` with the ``fc.*`` and ``num_batches_tracked`` entries a real
checkpoint carries. Tolerances: the ported tensors bitwise (no arithmetic
happens); forwards 1e-4 at 64x128 fp32, the JAX suite's tolerance for the
same porters (``tests/test_weight_port.py``).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as tF

from sph_retina_tpu.models import load_backbone as jax_load_backbone
from sph_retina_tpu_torch import models as tmodels
from sph_retina_tpu_torch import train as train_cli
from sph_retina_tpu_torch.engine.zoo import get_family
from sph_retina_tpu_torch.models import (
    ResNet,
    SSDVGG,
    load_backbone,
    load_torch_state_dict,
    port_mmdet_retinanet,
    port_torchvision_vgg16,
    port_torchvision_weights,
)
from sph_retina_tpu_torch.models import port as tport
from sph_retina_tpu_torch.models import port_mmdet as tport_mmdet
from sph_retina_tpu_torch.models import resnet as tresnet
from sph_retina_tpu_torch.models import vgg as tvgg
from sph_retina_tpu_torch.models.from_flax import from_flax, to_flax
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
SMALL = ["img_size=(64,128)", "bf16=False"]


# ------------------------------------------------ torchvision-layout modules
class TVBasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, **_):
        super().__init__()
        self.conv1 = tnn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = tF.relu(self.bn1(self.conv1(x)))
        return tF.relu(self.bn2(self.conv2(out)) + identity)


class TVBottleneck(tnn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = tnn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.conv2 = tnn.Conv2d(width, width, 3, stride, 1, groups=groups,
                                bias=False)
        self.bn2 = tnn.BatchNorm2d(width)
        self.conv3 = tnn.Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = tF.relu(self.bn1(self.conv1(x)))
        out = tF.relu(self.bn2(self.conv2(out)))
        return tF.relu(self.bn3(self.conv3(out)) + identity)


class TVResNet(tnn.Module):
    """torchvision.models.ResNet: topology and ``state_dict`` names,
    ``fc`` included."""

    def __init__(self, block, layers, groups=1, base_width=64):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        self.inplanes = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            down = None
            if stride != 1 or self.inplanes != planes * block.expansion:
                down = tnn.Sequential(
                    tnn.Conv2d(self.inplanes, planes * block.expansion, 1,
                               stride, bias=False),
                    tnn.BatchNorm2d(planes * block.expansion))
            blocks = [block(self.inplanes, planes, stride, down,
                            groups=groups, base_width=base_width)]
            self.inplanes = planes * block.expansion
            blocks += [block(self.inplanes, planes, groups=groups,
                             base_width=base_width) for _ in range(n - 1)]
            setattr(self, f"layer{i + 1}", tnn.Sequential(*blocks))
        self.fc = tnn.Linear(512 * block.expansion, 1000)

    def forward(self, x):
        x = self.maxpool(tF.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            outs.append(x)
        return outs


class TVVGG16(tnn.Module):
    """torchvision.models.vgg16: ``features`` indices 0..30, ``classifier``."""

    def __init__(self):
        super().__init__()
        cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]
        layers, in_ch = [], 3
        for v in cfg:
            if v == "M":
                layers.append(tnn.MaxPool2d(2, 2))
            else:
                layers += [tnn.Conv2d(in_ch, v, 3, padding=1), tnn.ReLU(True)]
                in_ch = v
        self.features = tnn.Sequential(*layers)
        self.classifier = tnn.Sequential(tnn.Linear(512 * 7 * 7, 16))


ARCHS = {
    "resnet18": lambda: TVResNet(TVBasicBlock, (2, 2, 2, 2)),
    "resnet50": lambda: TVResNet(TVBottleneck, (3, 4, 6, 3)),
    "resnext50_32x4d": lambda: TVResNet(TVBottleneck, (3, 4, 6, 3),
                                        groups=32, base_width=4),
    "vgg16": TVVGG16,
}


def seeded_torchvision(arch: str, seed: int) -> tnn.Module:
    """A torchvision-layout module with seeded weights and batch-norm
    statistics (running_var in [0.5, 1.5)), in eval mode."""
    torch.manual_seed(seed)
    m = ARCHS[arch]().eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, tnn.BatchNorm2d):
                n = mod.num_features
                mod.running_mean.copy_(torch.randn(n, generator=g) * 0.5)
                mod.running_var.copy_(torch.rand(n, generator=g) + 0.5)
                mod.weight.copy_(torch.rand(n, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(n, generator=g) * 0.1)
                mod.num_batches_tracked.fill_(7)
    return m


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """arch -> (module, .pth path), the files removed at the end."""
    tmp = tmp_path_factory.mktemp("tv_weights")
    out = {}
    for i, arch in enumerate(ARCHS):
        m = seeded_torchvision(arch, seed=i)
        path = str(tmp / f"{arch}.pth")
        torch.save(m.state_dict(), path)
        out[arch] = (m, path)
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


# (config, overrides, torchvision arch, port arch)
DETECTORS = {
    "resnet18": ("sph_rotated_retinanet_r50_fpn_120e_pandora.py",
                 ["model.backbone.depth=18"], "resnet18"),
    "resnet50": ("sph_rotated_retinanet_r50_fpn_120e_pandora.py", [],
                 "resnet50"),
    "resnext50_32x4d": ("sph_retinanet_x101_32x4d_fpn_120e_indoor360.py",
                        ["model.backbone.depth=50"], "resnet50"),
    "vgg16": ("sph_ssd_vgg16_120e_indoor360.py", [], "vgg16"),
}


def _detector(name):
    config, extra, _ = DETECTORS[name]
    cfg = apply_overrides(load_config(os.path.join(REPO, "configs", config)),
                          SMALL + extra)
    model, _ = get_family(cfg).build(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return cfg, model


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_loaded_backbone_equals_the_jax_packages(name, checkpoints):
    """(a) The port's ``load_backbone`` against the JAX package's on the same
    file and the same starting variables, through ``from_flax``: every
    tensor of the detector bitwise, the backbone's taken from the file."""
    cfg, model = _detector(name)
    _, path = checkpoints[name]
    params, stats = to_flax(model.state_dict())
    arch = DETECTORS[name][2]
    assert train_cli.backbone_arch(cfg) == arch
    want = jax_load_backbone({"params": params, "batch_stats": stats}, path,
                             arch=arch)
    assert load_backbone(model, path, arch) is model
    got = model.state_dict()
    want = from_flax(want["params"], want["batch_stats"])
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    sd = load_torch_state_dict(path)
    ported = (port_torchvision_vgg16(sd) if arch == "vgg16"
              else port_torchvision_weights(sd, int(arch[6:])))
    for k, v in ported.items():
        assert torch.equal(got[f"backbone.{k}"], v), k


@pytest.mark.parametrize("name, depth, groups", [
    ("resnet18", 18, 1), ("resnet50", 50, 1), ("resnext50_32x4d", 50, 32)])
def test_ported_resnet_forward_equals_torchvisions(name, depth, groups,
                                                   checkpoints):
    """(b) The port's ResNet with the ported weights against the torch
    module's eval forward, each of the four stages, 64x128 fp32."""
    tv, _ = checkpoints[name]
    sd = tv.state_dict()
    net = ResNet(depth=depth, groups=groups,
                 base_width=4 if groups > 1 else 64)
    net.load_state_dict(port_torchvision_weights(sd, depth), strict=True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 64, 128)).astype(np.float32))
    with torch.no_grad():
        want = tv(x)
        got = net(x)
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=ATOL)


def test_ported_vgg_forward_equals_torchvisions(checkpoints):
    """(b) VGG16: through conv4_3 (pre-ReLU, ``features`` index 21), the
    deepest tensor both compute alike (SSD's pool5 / conv6 differ by
    design); conv6, conv7 and the L2Norm scale are not in the port."""
    tv, _ = checkpoints["vgg16"]
    ported = port_torchvision_vgg16(tv.state_dict())
    assert len(ported) == 26 and not any(
        k.startswith(("conv6", "conv7", "l2_norm")) for k in ported)
    net = SSDVGG()
    own = net.state_dict()
    own.update(ported)
    net.load_state_dict(own)
    seen = {}
    net.conv4_3.register_forward_hook(
        lambda mod, inp, out: seen.setdefault("conv4_3", out))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 3, 64, 128)).astype(np.float32))
    with torch.no_grad():
        want = tv.features[:22](x)
        net(x)
    np.testing.assert_allclose(seen["conv4_3"].numpy(), want.numpy(),
                               atol=ATOL, rtol=ATOL)


def _trainer_run(argv, work):
    """``train.main(argv)`` with the parts ``build_training`` built and
    copies of the model's tensors and of the EMA shadow as the first step
    finds them."""
    seen = {}
    build = train_cli.build_training

    def capturing(*args, **kwargs):
        parts = build(*args, **kwargs)
        model, optimizer = parts[0], parts[3]
        seen["parts"] = parts
        seen["before"] = {k: v.clone() for k, v in
                          model.state_dict().items()}
        seen["ema"] = ({k: v.clone() for k, v in
                        optimizer.ema_state_dict().items()}
                       if optimizer.ema is not None else None)
        return parts

    train_cli.build_training = capturing
    try:
        assert train_cli.main(argv + ["--work-dir", str(work)]) == 0
    finally:
        train_cli.build_training = build
    with open(work / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    return seen, [r for r in records if r["prefix"] == "train"]


def test_the_trainer_takes_a_step_from_a_loaded_backbone(
        checkpoints, tmp_path, monkeypatch, capsys):
    """(c) ``train.main --load-backbone`` on the R18 Sphere-bench config:
    the first step finds the file's tensors in the model and in the EMA
    shadow; after it the frozen stem and every batch-norm statistic still
    equal the file's, a trained tensor does not."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tv, path = checkpoints["resnet18"]
    file_sd = {f"backbone.{k}": v for k, v in
               port_torchvision_weights(tv.state_dict(), 18).items()}
    argv = [os.path.join(REPO, "configs",
                         "sph_retinanet_r18_fpn_24e_spherebench.py"),
            "--synthetic", "--device", "cpu", "--max-epochs", "1",
            "--load-backbone", path, "--cfg-options", *SMALL,
            "data.samples_per_gpu=2", "data.n_synthetic=2", "data.max_gt=8",
            "log_config.interval=1", "ema_momentum=0.01"]
    work = tmp_path / "run"
    try:
        seen, steps = _trainer_run(argv, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert "loaded resnet18 backbone from" in capsys.readouterr().out
    assert [r["step"] for r in steps] == [1]
    assert all(np.isfinite(steps[0][k]) for k in ("loss", "loss_cls",
                                                  "loss_bbox"))
    model, optimizer = seen["parts"][0], seen["parts"][3]
    for k, v in file_sd.items():
        assert torch.equal(seen["before"][k], v.to(seen["before"][k].dtype)), k
        if k in seen["ema"]:
            assert torch.equal(seen["ema"][k], v), k
    after = model.state_dict()
    frozen = [k for k in file_sd if k.startswith(("backbone.conv1.",
                                                  "backbone.bn1."))
              or k.endswith(("running_mean", "running_var"))]
    # conv1 and bn1's weight and bias, and the two moments of each of the
    # 20 batch norms
    assert len(frozen) == 3 + 2 * 20
    for k in frozen:
        assert torch.equal(after[k], file_sd[k]), k
    assert "backbone.layer1_0.conv1.weight" in optimizer.names
    assert not torch.equal(after["backbone.layer1_0.conv1.weight"],
                           file_sd["backbone.layer1_0.conv1.weight"])


def test_load_backbone_refuses_what_does_not_fit(checkpoints, tmp_path):
    """(d) A ported key the model lacks raises ``KeyError``, a shape that
    differs ``ValueError``, an unknown arch ``ValueError``; nothing is
    copied before the check has passed."""
    _, r18 = _detector("resnet18")
    before = {k: v.clone() for k, v in r18.state_dict().items()}
    with pytest.raises(KeyError, match="layer1_0.conv3"):
        load_backbone(r18, checkpoints["resnet50"][1], "resnet50")
    sd = dict(checkpoints["resnet18"][0].state_dict())
    sd["layer2.0.conv1.weight"] = torch.zeros(128, 64, 5, 5)
    bad = str(tmp_path / "bad.pth")
    torch.save({"state_dict": sd}, bad)  # unwrapped from its container
    with pytest.raises(ValueError, match="layer2_0.conv1.weight"):
        load_backbone(r18, bad, "resnet18")
    with pytest.raises(ValueError, match="unknown backbone arch"):
        load_backbone(r18, checkpoints["resnet18"][1], "resnet19x")
    assert all(torch.equal(before[k], v)
               for k, v in r18.state_dict().items())
    os.remove(bad)


def test_the_weight_converters_are_reexported():
    """(e) The five names of the JAX package's ``models`` from the port's."""
    assert tmodels.port_torchvision_weights is tresnet.port_torchvision_weights
    assert tmodels.port_torchvision_vgg16 is tvgg.port_torchvision_vgg16
    assert tmodels.load_backbone is tport.load_backbone
    assert tmodels.load_torch_state_dict is tport.load_torch_state_dict
    assert tmodels.port_mmdet_retinanet is tport_mmdet.port_mmdet_retinanet
    assert port_mmdet_retinanet is tport_mmdet.port_mmdet_retinanet
    for name in ("port_torchvision_weights", "port_torchvision_vgg16",
                 "load_backbone", "load_torch_state_dict",
                 "port_mmdet_retinanet"):
        assert name in tmodels.__all__

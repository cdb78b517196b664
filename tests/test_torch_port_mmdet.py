"""Reference (mmdet-layout) checkpoints in the port: ``port_mmdet_retinanet``
and ``convert_reference_checkpoint``, against the JAX package's.

The tests build torch modules with mmdet's RetinaNet module tree and key
names (``backbone.layer{s}.{b}.*``, ``neck.lateral_convs`` / ``fpn_convs.
{i}.conv`` with the two ``add_extra_convs`` convs appended, ``bbox_head.
{cls,reg}_convs.{i}.conv``, ``retina_cls`` / ``retina_reg``) and seeded
weights and batch-norm statistics. Tolerances: the ported tensors and the
written arrays bitwise (no arithmetic happens); a forward 1e-4, the JAX
suite's tolerance for this port (``tests/test_port_mmdet.py``: 2e-4 against
torch).
"""

import importlib.util
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as tF

from sph_retina_tpu.engine import zoo as jzoo
from sph_retina_tpu.models import port_mmdet_retinanet as jax_port_mmdet
from sph_retina_tpu.utils.config import apply_overrides as japply
from sph_retina_tpu.utils.config import load_config as jload_config
from sph_retina_tpu.utils.publish import load_published as jax_load_published
from sph_retina_tpu_torch import convert_reference_checkpoint as convert_cli
from sph_retina_tpu_torch.apis import init_detector
from sph_retina_tpu_torch.engine.zoo import get_family
from sph_retina_tpu_torch.models import port_mmdet_retinanet
from sph_retina_tpu_torch.models.from_flax import from_flax
from sph_retina_tpu_torch.models.port_mmdet import split_prefix
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config
from sph_retina_tpu_torch.utils.publish import load_published

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs",
                      "sph_rotated_retinanet_r50_fpn_120e_pandora.py")
OPTIONS = ["model.backbone.depth=18", "img_size=(64,128)", "bf16=False"]
ATOL = 1e-4


class BasicBlock(tnn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=None):
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


class MMDetResNet18(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        inplanes = 64
        for s, (planes, stride) in enumerate(
                [(64, 1), (128, 2), (256, 2), (512, 2)]):
            down = None
            if stride != 1 or inplanes != planes:
                down = tnn.Sequential(
                    tnn.Conv2d(inplanes, planes, 1, stride, bias=False),
                    tnn.BatchNorm2d(planes))
            setattr(self, f"layer{s + 1}", tnn.Sequential(
                BasicBlock(inplanes, planes, stride, down),
                BasicBlock(planes, planes)))
            inplanes = planes

    def forward(self, x):
        x = tF.max_pool2d(tF.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            outs.append(x)
        return outs


class ConvModule(tnn.Module):
    """mmcv's ConvModule: the ``.conv`` child in the neck's and head's keys."""

    def __init__(self, cin, cout, k, stride=1, pad=0):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, k, stride, pad)

    def forward(self, x):
        return self.conv(x)


class MMDetRetinaNet(tnn.Module):
    """mmdet RetinaNet-R18: FPN with start_level 1, 5 outputs,
    ``add_extra_convs='on_input'``; the head's four convs a tower."""

    def __init__(self, num_classes, box_version, channels, anchors=9):
        super().__init__()
        self.nc, self.bv, self.a = num_classes, box_version, anchors
        self.backbone = MMDetResNet18()
        neck = tnn.Module()
        neck.lateral_convs = tnn.ModuleList(
            [ConvModule(c, channels, 1) for c in (128, 256, 512)])
        neck.fpn_convs = tnn.ModuleList(
            [ConvModule(channels, channels, 3, 1, 1) for _ in range(3)]
            + [ConvModule(512, channels, 3, 2, 1),
               ConvModule(channels, channels, 3, 2, 1)])
        self.neck = neck
        head = tnn.Module()
        for tower in ("cls", "reg"):
            setattr(head, f"{tower}_convs", tnn.ModuleList(
                [ConvModule(channels, channels, 3, 1, 1) for _ in range(4)]))
        head.retina_cls = tnn.Conv2d(channels, anchors * num_classes, 3, 1, 1)
        head.retina_reg = tnn.Conv2d(channels, anchors * box_version, 3, 1, 1)
        self.bbox_head = head

    def forward(self, x):
        feats = self.backbone(x)
        n = self.neck
        lat = [m(feats[i + 1]) for i, m in enumerate(n.lateral_convs)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + tF.interpolate(lat[i], scale_factor=2,
                                                     mode="nearest")
        outs = [n.fpn_convs[i](lat[i]) for i in range(3)]
        outs.append(n.fpn_convs[3](feats[-1]))
        outs.append(n.fpn_convs[4](outs[-1]))
        cls_out, reg_out = [], []
        h = self.bbox_head
        for x in outs:
            c, r = x, x
            for m in h.cls_convs:
                c = tF.relu(m(c))
            for m in h.reg_convs:
                r = tF.relu(m(r))
            b, _, hh, ww = x.shape
            cls_out.append(h.retina_cls(c).permute(0, 2, 3, 1)
                           .reshape(b, hh * ww * self.a, self.nc))
            reg_out.append(h.retina_reg(r).permute(0, 2, 3, 1)
                           .reshape(b, hh * ww * self.a, self.bv))
        return cls_out, reg_out


def seeded_mmdet(num_classes, box_version, channels, seed):
    torch.manual_seed(seed)
    m = MMDetRetinaNet(num_classes, box_version, channels).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for mod in m.modules():
            if isinstance(mod, tnn.BatchNorm2d):
                mod.running_mean.copy_(
                    torch.randn(mod.num_features, generator=g) * 0.5)
                mod.running_var.copy_(
                    torch.rand(mod.num_features, generator=g) + 0.5)
    return m


@pytest.mark.parametrize("box_version", [4, 5])
def test_port_mmdet_retinanet_equals_the_jax_packages(box_version):
    """Every ported tensor bitwise the JAX package's through ``from_flax``,
    for tensors and for numpy arrays in; the key set is the detector's."""
    tm = seeded_mmdet(3, box_version, 64, seed=box_version)
    sd = tm.state_dict()
    got = port_mmdet_retinanet(sd, depth=18)
    want = jax_port_mmdet({k: v.numpy() for k, v in sd.items()}, depth=18)
    want = from_flax(want["params"], want["batch_stats"])
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    from_numpy = port_mmdet_retinanet({k: v.numpy() for k, v in sd.items()},
                                      depth=18)
    assert all(torch.equal(from_numpy[k], got[k]) for k in got)
    # the extras follow the laterals: fpn_convs.3 is the 512 -> C stride-2
    # conv on the backbone's last stage
    assert torch.equal(got["neck.extra_conv_0.weight"],
                       sd["neck.fpn_convs.3.conv.weight"])
    assert torch.equal(got["neck.fpn_conv_2.bias"],
                       sd["neck.fpn_convs.2.conv.bias"])
    cfg = apply_overrides(load_config(CONFIG), OPTIONS + [
        "model.num_classes=3", f"model.box_version={box_version}"])
    with torch.device("meta"):  # the names, no memory (the widths differ:
        model, _ = get_family(cfg).build(cfg)  # 64 here, 256 in the config)
    assert model.state_dict().keys() == got.keys()
    assert not any("num_batches_tracked" in k
                   for k in split_prefix(sd, "backbone."))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A seeded mmdet RetinaNet-R18 of the rotated config's width (256
    channels, 47 classes, 5-dof) saved as an mmcv checkpoint, converted by
    the port's CLI and by the JAX package's tool; the files removed at the
    end."""
    tmp = tmp_path_factory.mktemp("mmdet")
    tm = seeded_mmdet(47, 5, 256, seed=11)
    pth = str(tmp / "ref_epoch_3.pth")
    torch.save({"meta": {"epoch": 3, "mmdet_version": "2.x"},
                "state_dict": tm.state_dict()}, pth)
    assert convert_cli.main([pth, str(tmp / "port" / "out.npz"),
                             "--depth", "18"]) == 0
    argv = sys.argv
    sys.argv = ["convert_reference_checkpoint.py", pth,
                str(tmp / "jax" / "out.npz"), "--depth", "18"]
    try:
        _jax_tool("convert_reference_checkpoint").main()
    finally:
        sys.argv = argv
    (port_npz,) = os.listdir(tmp / "port")
    (jax_npz,) = os.listdir(tmp / "jax")
    yield tm, str(tmp / "port" / port_npz), str(tmp / "jax" / jax_npz)
    shutil.rmtree(tmp, ignore_errors=True)


def test_converted_files_equal_the_jax_tools(converted):
    """The port's CLI and the JAX tool write the same arrays and meta; each
    package's ``load_published`` reads the port's file."""
    _, port_npz, jax_npz = converted
    assert os.path.basename(port_npz).startswith("out-")
    with np.load(port_npz) as a, np.load(jax_npz) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    p1, s1, m1 = load_published(port_npz)
    p2, s2, m2 = jax_load_published(port_npz)
    assert m1 == m2 == {"source": "ref_epoch_3.pth", "epoch": 3}
    flat1 = jax.tree_util.tree_leaves_with_path((p1, s1))
    flat2 = dict(jax.tree_util.tree_leaves_with_path((p2, s2)))
    assert len(flat1) == len(flat2)
    for path, leaf in flat1:
        np.testing.assert_array_equal(leaf, flat2[path])


def test_the_converted_detector_equals_the_jax_packages(converted):
    """The slice as a whole: the port's ``init_detector`` on the converted
    file against the JAX package's network on the same file, each level's
    class and box outputs within 1e-4, and both against the mmdet module."""
    tm, port_npz, _ = converted
    det = init_detector(CONFIG, port_npz, cfg_options=OPTIONS, device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 64, 128, 3)).astype(
        np.float32)
    with torch.no_grad():
        cls_t, reg_t = det.model(torch.from_numpy(x))
        cls_m, reg_m = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))

    jcfg = japply(jload_config(CONFIG), OPTIONS)
    jmodel, _ = jzoo.get_family(jcfg).build(jcfg)
    params, stats, _ = jax_load_published(port_npz)
    cls_j, reg_j = jax.jit(jmodel.apply)(
        {"params": params, "batch_stats": stats}, x)
    assert len(cls_t) == len(cls_j) == 5
    for lvl in range(5):
        for t, j, m in ((cls_t, cls_j, cls_m), (reg_t, reg_j, reg_m)):
            np.testing.assert_allclose(t[lvl].numpy(), np.asarray(j[lvl]),
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(t[lvl].numpy(), m[lvl].numpy(),
                                       atol=ATOL, rtol=0)

"""The PyTorch port as a package: what it imports, and its own copies of the
JAX package's host-side helpers (config loader, published-checkpoint reader,
image preparation) against the originals."""

import ast
import glob
import importlib
import os
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_retina_tpu_torch
from sph_retina_tpu.data.pipeline import SphPipeline as JaxPipeline
from sph_retina_tpu.engine.train import maybe_normalize_images as jax_normalize
from sph_retina_tpu.utils import config as jconfig
from sph_retina_tpu.utils.publish import load_published as jax_load_published
from sph_retina_tpu.utils.publish import save_published
from sph_retina_tpu_torch.data.pipeline import SphPipeline, maybe_normalize_images
from sph_retina_tpu_torch.engine.builder import build_detector_config
from sph_retina_tpu_torch.utils import config as tconfig
from sph_retina_tpu_torch.utils.publish import load_published

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "sph_retina_tpu", "triton"}  # both kernels are CUDA C++


def _port_sources():
    root = os.path.dirname(sph_retina_tpu_torch.__file__)
    files = sorted(glob.glob(os.path.join(root, "**", "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    return files


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """Every import statement of every module of the port and of
    ``chip_smoke.py``, wherever in the file it stands (function bodies
    included), names neither JAX nor anything of ``sph_retina_tpu``."""
    files = _port_sources()
    assert len(files) > 35
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_every_module_of_the_port_imports():
    """Importing builds no kernel and needs neither nvcc nor a card."""
    names = [m.name for m in pkgutil.walk_packages(
        sph_retina_tpu_torch.__path__, "sph_retina_tpu_torch.")]
    assert "sph_retina_tpu_torch.ops.sph2pob_iou" in names
    assert "sph_retina_tpu_torch.serve" in names
    assert "sph_retina_tpu_torch.train" in names
    assert "sph_retina_tpu_torch.benchmark_iou" in names
    assert "sph_retina_tpu_torch.engine.runner" in names
    for name in names:
        importlib.import_module(name)


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(REPO, "configs", "*.py"))),
    ids=os.path.basename)
def test_config_loader_equals_the_jax_packages(path):
    assert tconfig.load_config(path) == jconfig.load_config(path)


def test_config_overrides_delete_and_interpolation(tmp_path):
    (tmp_path / "base.py").write_text(
        "model = dict(loss=dict(type='A', beta=1.0), depth=50)\n"
        "work = 'runs'\n")
    (tmp_path / "leaf.py").write_text(
        "_base_ = ['base.py']\n"
        "model = dict(loss=dict(_delete_=True, type='B'))\n"
        "out = '${work}/leaf'\n"
        "depth = '${model.depth}'\n")
    opts = ["model.depth=18", "img_size=(64,128)", "name=plain"]
    for mod in (tconfig, jconfig):
        cfg = mod.apply_overrides(mod.load_config(str(tmp_path / "leaf.py")),
                                  opts)
        assert cfg["model"] == {"loss": {"type": "B"}, "depth": 18}
        assert cfg["out"] == "runs/leaf" and cfg["depth"] == 50
        assert cfg["img_size"] == (64, 128) and cfg["name"] == "plain"


def test_rotated_config_builds_the_serving_detector_config():
    cfg = tconfig.load_config(os.path.join(
        REPO, "configs", "sph_rotated_retinanet_r50_fpn_120e_pandora.py"))
    det = build_detector_config(cfg)
    assert (det.num_classes, det.box_version) == (47, 5)
    assert det.nms_backend == "sph2pob_efficient"
    assert (det.nms_pre, det.max_per_img, det.score_thr, det.nms_iou_thr) \
        == (1000, 100, 0.05, 0.5)
    assert det.featmap_sizes() == [(64, 128), (32, 64), (16, 32), (8, 16),
                                   (4, 8)]
    assert tuple(det.flat_anchors().shape) == (98208, 5)


def test_a_config_whose_loss_is_not_available_still_builds_for_inference():
    cfg = tconfig.load_config(os.path.join(
        REPO, "configs", "sph_kent_retinanet_kld_120e_indoor360.py"))
    det = build_detector_config(cfg)
    assert det.reg_decoded_bbox and det.num_classes == 37
    # KentLoss is available now: the built loss gives a finite value
    boxes = torch.tensor([[90.0, 90.0, 30.0, 40.0], [200.0, 60.0, 50.0, 20.0]])
    assert torch.isfinite(det.loss_bbox(boxes, boxes + 1.0))


def test_load_published_equals_the_jax_packages(tmp_path):
    rng = np.random.default_rng(0)
    params = {"backbone": {"conv1": {"kernel": rng.normal(
        size=(3, 3, 2, 4)).astype(np.float32)}},
        "neck": {"lateral_0": {"bias": rng.normal(size=4).astype(np.float32)}}}
    stats = {"backbone": {"bn1": {"mean": np.zeros(4, np.float32),
                                  "var": np.ones(4, np.float32)}}}
    path = save_published(str(tmp_path / "m.npz"), params, stats, {"k": 1})
    got, want = load_published(path), jax_load_published(path)
    assert got[2] == want[2] == {"k": 1}

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])

    same(got[0], want[0])
    same(got[1], want[1])
    same(got[0], params)


def test_image_preparation_equals_the_jax_packages():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (40, 90, 3), dtype=np.uint8)
    tp = SphPipeline(img_size=(32, 64))
    jp = JaxPipeline(img_size=(32, 64), training=False)
    resized = tp.resize(img)
    np.testing.assert_array_equal(resized, jp.resize(img))
    np.testing.assert_array_equal(tp.normalize(resized), jp.normalize(resized))
    assert tp.resize(resized) is resized  # right size: no decoder needed

    batch = np.stack([resized, resized[::-1].copy()])
    got = maybe_normalize_images(torch.from_numpy(batch)).numpy()
    want = np.asarray(jax_normalize(jnp.asarray(batch)))
    # the same fp32 subtraction and division on both sides
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0], tp.normalize(resized), atol=1e-6, rtol=0)
    as_float = torch.from_numpy(got)
    assert maybe_normalize_images(as_float) is as_float

"""The PyTorch port as a package: what it imports, and its own copies of the
JAX package's host-side helpers (config loader, published-checkpoint reader,
image preparation) against the originals."""

import ast
import dataclasses
import functools
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
from sph_retina_tpu import losses as jlosses
from sph_retina_tpu.engine import zoo as jzoo
from sph_retina_tpu.engine.train import maybe_normalize_images as jax_normalize
from sph_retina_tpu.utils import config as jconfig
from sph_retina_tpu.utils.publish import load_published as jax_load_published
from sph_retina_tpu.utils.publish import save_published
from sph_retina_tpu_torch.data.pipeline import SphPipeline, maybe_normalize_images
from sph_retina_tpu_torch import losses as tlosses
from sph_retina_tpu_torch.engine import zoo as tzoo
from sph_retina_tpu_torch.engine.builder import build_detector_config
from sph_retina_tpu_torch.utils import config as tconfig
from sph_retina_tpu_torch.utils.publish import load_published

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "sph_retina_tpu", "triton",  # both kernels are CUDA C++
             "cv2",  # the card's host has no OpenCV: data/imgproc.py
             "matplotlib", "imageio"}  # nor these: visualize/canvas.py


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
    included), names neither JAX nor anything of ``sph_retina_tpu``, nor
    OpenCV, matplotlib or imageio."""
    files = _port_sources()
    assert len(files) > 35
    names = {os.path.relpath(f, REPO) for f in files}
    assert {f"sph_retina_tpu_torch/{m}.py" for m in (
        "data/imgproc", "data/corruptions", "test_robustness",
        "robustness_eval", "eval_metric", "eval_pr_curve",
        "boxes/anchor_opt", "visualize/canvas", "visualize/plots",
        "visualize/camera", "visualize/kent_vis", "optimize_anchors",
        "image_demo", "browse_dataset", "vis_kent", "create_result_gif",
        "analyze_logs", "print_config", "get_flops", "benchmark_fps",
        "profile_step", "mfu_experiment", "bench_host_pipeline",
        "synth_dataset", "assign_audit", "ap_study", "detection_diagnosis",
        "chart_util", "convert_anno", "images2coco", "get_image_metas",
        "split_coco", "pascal_voc", "cityscapes")} <= names
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


# Public names of the JAX package's subpackages that the port does not have:
# their modules are not ported yet (ROADMAP, Queue A), or, for the engine's,
# they have no counterpart by design (the model and the optimiser hold the
# training state, updated in place).
NOT_PORTED = {
    "data": set(),
    "iou": set(),
    "boxes": set(),
    "geometry": set(),
    "models": set(),
    "engine": {"TrainState", "create_train_state", "shard_batch"},
    # data_mesh, make_global_batch: no counterpart (each rank keeps its
    # local batch); replicate_to_mesh is broadcast_parameters here
    "parallel": {"data_mesh", "make_global_batch", "replicate_to_mesh"},
    "visualize": set(),
}


@pytest.mark.parametrize("sub", sorted(NOT_PORTED))
def test_subpackages_export_every_ported_public_name(sub):
    """Every name of a JAX subpackage's ``__all__`` whose module is ported
    imports from the port's subpackage of the same name."""
    jax_sub = importlib.import_module(f"sph_retina_tpu.{sub}")
    port_sub = importlib.import_module(f"sph_retina_tpu_torch.{sub}")
    want = set(jax_sub.__all__) - NOT_PORTED[sub]
    assert NOT_PORTED[sub] <= set(jax_sub.__all__)
    assert want <= set(port_sub.__all__), sorted(want - set(port_sub.__all__))
    for name in port_sub.__all__:
        assert getattr(port_sub, name) is not None, name


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(REPO, "configs", "*.py"))),
    ids=os.path.basename)
def test_config_loader_equals_the_jax_packages(path):
    assert tconfig.load_config(path) == jconfig.load_config(path)


def _comparable(value, losses: dict):
    """A config field as plain data: a loss by its type name in the
    package's ``LOSSES`` and its keywords, a dataclass (anchor generator,
    coder, assigner) by its class and fields."""
    names = {fn: kind for kind, fn in losses.items()}
    if isinstance(value, functools.partial):
        return (names[value.func], value.keywords)
    if callable(value) and not dataclasses.is_dataclass(value):
        return names[value]
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,
                {f.name: _comparable(getattr(value, f.name), losses)
                 for f in dataclasses.fields(value)})
    if isinstance(value, (list, tuple)):
        return tuple(_comparable(v, losses) for v in value)
    return value


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(REPO, "configs", "*.py"))),
    ids=os.path.basename)
def test_every_config_builds_the_same_detector_in_both_packages(path):
    """``get_family(cfg).build`` of both packages: the same family and
    module, and detector configs that differ only in ``approx_topk``, the
    JAX package's approximate top-k on the TPU (the port's is exact)."""
    cfg = tconfig.load_config(path)
    jmodel, jdet = jzoo.get_family(cfg).build(cfg)
    with torch.device("meta"):  # no parameter memory, no initialisation
        tmodel, tdet = tzoo.get_family(cfg).build(cfg)
    assert tzoo.get_family(cfg).name == jzoo.get_family(cfg).name
    assert type(tmodel).__name__ == type(jmodel).__name__
    assert type(tdet).__name__ == type(jdet).__name__
    got = _comparable(tdet, tlosses.LOSSES)[1]
    want = _comparable(jdet, jlosses.LOSSES)[1]
    assert set(want) - set(got) <= {"approx_topk"}
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}


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

"""The port's sphere-bench writer (``sph_retina_tpu_torch/synth_dataset.py``)
against the JAX package's (``tools/synth_dataset.py``), and the study's
``ensure_dataset`` (``sph_retina_tpu_torch/ap_study.py``).

The same numpy inputs through both; geometry within 1e-12 (float64), the
annotation files' bytes and the PNGs' pixels equal. The committed
``work_dirs/sphere_bench`` annotations hold the published parameters' first
20 train images. Everything written lies under ``tmp_path`` and is removed
once the test is done.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from sph_retina_tpu_torch import ap_study
from sph_retina_tpu_torch import synth_dataset as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "work_dirs", "sphere_bench", "annotations")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_synth_dataset", os.path.join(REPO, "tools", "synth_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_tool = _jax_tool()


@pytest.fixture
def emptied_tmp_path(tmp_path):
    """``tmp_path``, emptied once the test is done with it."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _boxes(d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(0, 360, 16), rng.uniform(5, 175, 16),
            rng.uniform(5, 90, 16), rng.uniform(5, 90, 16)]
    if d == 5:
        cols.append(rng.uniform(-45, 45, 16))
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("d", [4, 5])
def test_geometry_equals_the_jax_tools(d):
    dirs_p, dirs_j = port.erp_dirs(48, 96), jax_tool.erp_dirs(48, 96)
    np.testing.assert_allclose(dirs_p, dirs_j, rtol=0, atol=1e-12)
    for box in _boxes(d, seed=d):
        np.testing.assert_allclose(port.box_planes(box),
                                   jax_tool.box_planes(box),
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(port.box_mask(dirs_p, box),
                                      jax_tool.box_mask(dirs_j, box))
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(port._smooth_background(rng_p, 48, 96),
                                  jax_tool._smooth_background(rng_j, 48, 96))


@pytest.mark.parametrize("d", [4, 5])
def test_split_bytes_and_pixels_equal_the_jax_tools(d, emptied_tmp_path):
    kw = dict(split="val", n_images=4, num_classes=5, img_size=(128, 256),
              box_version=d, seed=11)
    ann_p, img_p = port.write_sphere_bench(str(emptied_tmp_path / "p"), **kw)
    ann_j, img_j = jax_tool.write_sphere_bench(str(emptied_tmp_path / "j"),
                                               **kw)
    with open(ann_p, "rb") as fp, open(ann_j, "rb") as fj:
        assert fp.read() == fj.read()
    names = sorted(os.listdir(img_j))
    assert sorted(os.listdir(img_p)) == names and len(names) == 4
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(img_p, name))),
            np.asarray(Image.open(os.path.join(img_j, name))))


def test_published_parameters_give_the_committed_annotations(
        emptied_tmp_path):
    """The first 20 train images at 256x512, 12 classes, seed 0: their
    image and annotation entries are the committed file's first ones."""
    ann, _ = port.write_sphere_bench(str(emptied_tmp_path), split="train",
                                     n_images=20, seed=0)
    with open(ann) as f:
        got = json.load(f)
    with open(os.path.join(COMMITTED, "instances_train.json")) as f:
        want = json.load(f)
    assert got["images"] == want["images"][:20]
    n = len(got["annotations"])
    assert got["annotations"] == want["annotations"][:n]
    assert want["annotations"][n]["image_id"] == 21
    assert got["categories"] == want["categories"]


def test_ensure_dataset_regenerates_an_interrupted_generation(
        emptied_tmp_path):
    """Annotations present and the last train image missing: generated
    again; a whole dataset is left as it is."""
    root = str(emptied_tmp_path / "bench")
    kw = dict(n_train=6, n_val=3, num_classes=3, img_size=(64, 128), seed=0)
    ap_study.ensure_dataset(root, **kw)
    last = os.path.join(root, "images", "train_00006.png")
    assert os.path.exists(last)
    os.remove(last)
    ap_study.ensure_dataset(root, **kw)
    assert os.path.exists(last)
    mtime = os.path.getmtime(last)
    ap_study.ensure_dataset(root, **kw)
    assert os.path.getmtime(last) == mtime


def test_ensure_dataset_never_replaces_other_annotations(emptied_tmp_path):
    """An annotation file with other bytes than the parameters give (the
    committed 500-image file under a 24-image ``--quick`` request) raises,
    and neither it nor the image directory is touched."""
    root = emptied_tmp_path / "bench"
    (root / "annotations").mkdir(parents=True)
    committed = os.path.join(COMMITTED, "instances_train.json")
    shutil.copy(committed, root / "annotations" / "instances_train.json")
    with pytest.raises(FileExistsError, match="not replaced"):
        ap_study.ensure_dataset(str(root), seed=0, **ap_study.QUICK_DATASET)
    with open(committed, "rb") as f:
        assert (root / "annotations" / "instances_train.json").read_bytes() \
            == f.read()
    assert not (root / "images").exists()


def test_quick_study_defaults_its_dataset_under_the_output(
        monkeypatch, emptied_tmp_path):
    """``--quick`` without ``--data-root`` writes under ``--out``, never at
    the configs' ``work_dirs/sphere_bench``; without ``--quick`` the data
    root is the configs'."""
    seen = []

    class Stop(Exception):
        pass

    def stop(root, **kw):
        seen.append((root, kw["n_train"]))
        raise Stop

    monkeypatch.setattr(ap_study, "ensure_dataset", stop)
    out = str(emptied_tmp_path / "out")
    for argv in (["--quick"], []):
        with pytest.raises(Stop):
            ap_study.main(argv + ["--out", out, "--device", "cpu"])
    assert seen == [(os.path.join(out, "sphere_bench"), 24),
                    ("work_dirs/sphere_bench", 500)]

"""The port's deployment tools, in process: ``export_model.main`` writes an
artifact, ``deployment_test.main`` scores it over the synthetic set, and its
metrics equal ``evaluate_dataset`` with the live predict on the same
weights (the JAX test's bound, ``tests/test_deployment_test.py``, is 1e-3;
on the CPU the artifact equals the live predict bitwise, so the metrics
agree exactly, ragged last batch included).

The rotated config cut to R18 / 64x128 / fp32; its weights a published
``.npz`` of the port's random initialisation with the classification bias
drawn from a seeded normal, so that detections pass ``score_thr``.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from sph_retina_tpu_torch import deployment_test, export_model
from sph_retina_tpu_torch.apis import init_detector
from sph_retina_tpu_torch.data import (
    DataLoader,
    SphPipeline,
    make_synthetic_dataset,
)
from sph_retina_tpu_torch.engine.evaluator import evaluate_dataset
from sph_retina_tpu_torch.models.from_flax import to_flax
from sph_retina_tpu_torch.utils.publish import save_published

CONFIG = "configs/sph_rotated_retinanet_r50_fpn_120e_pandora.py"
OPTIONS = ["model.backbone.depth=18", "img_size=(64,128)", "bf16=False"]
BATCH = 3  # 16 synthetic images: the last batch is ragged


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("deploy")
    det = init_detector(CONFIG, cfg_options=OPTIONS, device="cpu")
    bias = det.model.bbox_head.retina_cls.bias
    with torch.no_grad():
        bias.copy_(torch.from_numpy(np.random.default_rng(0).normal(
            0.0, 1.0, bias.shape).astype(np.float32)))
    npz = save_published(str(tmp / "model.npz"),
                         *to_flax(det.model.state_dict()))
    out = str(tmp / "model.pt2")
    image = str(tmp / "img.png")
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (64, 128, 3), dtype=np.uint8)).save(image)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        assert export_model.main([
            CONFIG, npz, out, "--batch-size", str(BATCH), "--device", "cpu",
            "--run", image, "--cfg-options", *OPTIONS]) == 0
    yield npz, out, tmp, said.getvalue()
    shutil.rmtree(tmp, ignore_errors=True)  # the .npz and the artifact


def test_deployment_metrics_equal_the_in_framework_evaluation(artifact):
    npz, out, tmp, _ = artifact
    res = str(tmp / "res.json")
    assert deployment_test.main([CONFIG, out, "--synthetic", "--device",
                                 "cpu", "--out", res, "--cfg-options",
                                 *OPTIONS]) == 0
    with open(res) as f:
        deployed = json.load(f)

    det = init_detector(CONFIG, npz, cfg_options=OPTIONS, device="cpu")
    ds = make_synthetic_dataset(n_images=16, num_classes=47,
                                img_size=(64, 128), box_version=5)
    pipe = SphPipeline(img_size=(64, 128), training=False, box_version=5)
    loader = DataLoader(ds, pipe, batch_size=BATCH, shuffle=False,
                        drop_last=False)
    expected, raw = evaluate_dataset(det.model, det.det_cfg, loader,
                                     predict=det.predict, return_raw=True)
    assert raw["valid"].sum() > 100  # the matcher had detections to score
    floats = {k: v for k, v in expected.items() if isinstance(v, float)}
    assert set(deployed) == set(floats)
    for k, v in floats.items():
        assert deployed[k] == v, (k, deployed[k], v)


def test_export_prints_the_size_and_the_detections_of_image_zero(artifact):
    _, out, _, said = artifact
    lines = said.splitlines()
    assert lines[0] == f"exported {os.path.getsize(out) / 1e6:.1f} MB -> {out}"
    assert lines[1] == "artifact ran: 100 detections in image 0"


def test_a_config_of_another_img_size_is_refused(artifact):
    _, out, _, _ = artifact
    with pytest.raises(SystemExit, match="img_size"):
        deployment_test.main([CONFIG, out, "--synthetic", "--device", "cpu",
                              "--cfg-options", "model.backbone.depth=18",
                              "img_size=(128,256)", "bf16=False"])


def test_the_tools_raise_without_a_card_unless_given_the_cpu(artifact,
                                                             tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    npz, out, _, _ = artifact
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model.main([CONFIG, npz, str(tmp_path / "b.pt2"),
                           "--cfg-options", *OPTIONS])
    with pytest.raises(RuntimeError, match="CUDA"):
        deployment_test.main([CONFIG, out, "--synthetic", "--cfg-options",
                              *OPTIONS])
    assert not (tmp_path / "b.pt2").exists()


def test_an_annotation_file_scores_alike_from_uint8_and_float_batches(
        artifact, tmp_path):
    """The config's test split (``build_datasets``) at the artifact's batch
    size, its last batch ragged; batches the loader yields as uint8
    (``normalize_on_device``) are normalised on the device first and score
    as the host-normalised float batches do."""
    from utils.synthetic_coco import write_synthetic_coco

    _, out, _, _ = artifact
    ann, img = write_synthetic_coco(str(tmp_path), n_images=5,
                                    num_classes=47, box_version=5, seed=3,
                                    split="test")
    data = [f"data.test.ann_file={ann}", f"data.test.img_prefix={img}/",
            "data.workers_per_gpu=0"]
    said = []
    for on_device in (False, True):
        res = str(tmp_path / f"res_{on_device}.json")
        assert deployment_test.main([
            CONFIG, out, "--device", "cpu", "--out", res, "--cfg-options",
            *OPTIONS, *data, f"data.normalize_on_device={on_device}"]) == 0
        with open(res) as f:
            said.append(json.load(f))
    assert said[0] == said[1] and "AP50" in said[0]

"""The serving slice of the PyTorch port as a whole, on ``device="cpu"``.

The shipped rotated config (RBFoV, ``iou_calculator="sph2pob_efficient"``) cut
to R18 / 64x128 / fp32 by ``cfg_options``; one published ``.npz`` written by
the JAX package's ``save_published`` is loaded by both ``init_detector``s and
the same seeded uint8 images go through both ``inference_detector``s.

Tolerance: labels, validity and counts exactly; scores 1e-4 absolute (fp32
networks that agree to 1e-4); boxes 5e-3 degrees, which is 1e-4 in the
regression deltas times the 50 degrees of a large anchor's field of view
(decode multiplies dx, dy by it). On the
CPU the JAX NMS takes the stacked ``sph_overlaps`` path, which differs from
the fused body by up to 1e-4, so a pair within 1e-4 of the IoU threshold
could flip a decision: the test asserts that the seed has no such pair.
"""

import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from sph_retina_tpu import apis as japis
from sph_retina_tpu.engine.zoo import get_family as jax_get_family
from sph_retina_tpu.utils.publish import save_published
from sph_retina_tpu_torch import apis as tapis
from sph_retina_tpu_torch.boxes import nms as tnms
from sph_retina_tpu_torch.ops import sph2pob_iou_pairwise
from sph_retina_tpu_torch.serve import make_handler

CONFIG = "configs/sph_rotated_retinanet_r50_fpn_120e_pandora.py"
OPTIONS = ["model.backbone.depth=18", "img_size=(64,128)", "bf16=False"]
H, W = 64, 128
BOX_ATOL = 5e-3


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    import os

    config = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), CONFIG)
    jdet = japis.init_detector(config, cfg_options=OPTIONS, seed=0)

    # random init biases retina_cls to p ~ 0.01, below score_thr: raise it,
    # with seeded numpy values, so that well over nms_pre scores pass
    rng = np.random.default_rng(0)
    params = jax.device_get(jdet.variables["params"])
    head = dict(params["bbox_head"])
    cls = dict(head["retina_cls"])
    cls["bias"] = rng.normal(0.0, 1.0, cls["bias"].shape).astype(np.float32)
    head["retina_cls"] = cls
    params = dict(params, bbox_head=head)
    path = save_published(
        str(tmp_path_factory.mktemp("ckpt") / "model.npz"), params,
        jax.device_get(jdet.variables["batch_stats"]), {"note": "test"})

    jdet = japis.init_detector(config, checkpoint=path, cfg_options=OPTIONS)
    # exact preselection on the JAX side (approx_max_k is a TPU device)
    jdet.det_cfg = dataclasses.replace(jdet.det_cfg, approx_topk=False)
    jdet.predict = jax.jit(
        jax_get_family(jdet.cfg).predict_fn(jdet.model, jdet.det_cfg))
    tdet = tapis.init_detector(config, checkpoint=path, cfg_options=OPTIONS,
                               device="cpu")
    images = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
              for _ in range(2)]
    return jdet, tdet, images


def test_config_is_the_rotated_one(detectors):
    _, tdet, _ = detectors
    assert tdet.box_version == 5 and tdet.num_classes == 47
    assert tdet.det_cfg.nms_backend == "sph2pob_efficient"
    assert tdet.det_cfg.nms_pre == 1000 and tdet.det_cfg.max_per_img == 100
    assert tdet.device.type == "cpu"
    assert next(tdet.model.parameters()).dtype == torch.float32


def test_inference_detector_results_equal(detectors, monkeypatch):
    jdet, tdet, images = detectors
    margins = []
    greedy = tnms._greedy_suppress

    def recording(iou, valid, thr):
        """Distance to the threshold of the comparisons a flip of which
        would change the kept set: for a kept box every earlier kept box
        (all below the threshold), for a suppressed box the largest of its
        overlaps with earlier kept boxes (all of those must fall)."""
        keep = greedy(iou, valid, thr)
        by_kept = keep[:, None].expand_as(iou).triu(diagonal=1)
        below = torch.where(by_kept, thr - iou, torch.inf).amin(dim=0)
        above = torch.where(by_kept, iou - thr, -torch.inf).amax(dim=0)
        margins.append(float(torch.where(
            keep, below, torch.where(valid, above, torch.inf)).min()))
        return keep

    monkeypatch.setattr(tnms, "_greedy_suppress", recording)
    launches = sph2pob_iou_pairwise.launches
    got = tapis.inference_detector(tdet, images)
    want = japis.inference_detector(jdet, images)
    assert sph2pob_iou_pairwise.launches == launches  # CPU: plain version

    assert len(margins) == len(images)
    margin = min(margins)
    assert margin > 1e-4, (
        f"a deciding pair lies {margin:.2e} from the NMS threshold: pick "
        "another seed")

    assert len(got) == len(want) == 2
    total = 0
    for g_img, w_img in zip(got, want):
        assert len(g_img) == len(w_img) == 47
        for c, (g, w) in enumerate(zip(g_img, w_img)):
            assert g.shape == w.shape, (
                f"class {c}: {g.shape} vs {w.shape}; smallest |iou - thr| "
                f"among deciding pairs {margin:.3e}")
            assert g.dtype == np.float32 and g.shape[1] == 6
            np.testing.assert_allclose(g[:, -1], w[:, -1], atol=1e-4, rtol=0)
            np.testing.assert_allclose(g[:, :-1], w[:, :-1], atol=BOX_ATOL,
                                       rtol=0)
            total += len(g)
    assert total > 20  # the NMS had real candidates


def test_single_image_is_unwrapped_and_float_input_is_taken(detectors):
    _, tdet, images = detectors
    one = tapis.inference_detector(tdet, images[0])
    both = tapis.inference_detector(tdet, images)
    assert len(one) == 47
    for a, b in zip(one, both[0]):
        # a batch of two takes other convolution code than a batch of one
        np.testing.assert_allclose(a, b, atol=BOX_ATOL, rtol=0)
    as_float = tapis.inference_detector(tdet, images[0].astype(np.float64))
    for a, b in zip(one, as_float):
        np.testing.assert_array_equal(a, b)


def test_predict_round_trip_through_the_handler(detectors):
    _, tdet, images = detectors
    classes = [f"c{i}" for i in range(47)]
    handler = make_handler(tdet, classes, 0.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/ping", timeout=10) as r:
            assert json.load(r) == {"status": "ok"}

        buf = io.BytesIO()
        np.save(buf, images[0])
        req = urllib.request.Request(
            base + "/predict", data=buf.getvalue(), method="POST",
            headers={"Content-Type": "application/x-npy"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            dets = json.load(r)
        direct = tapis.inference_detector(tdet, images[0])
        assert len(dets) == sum(len(d) for d in direct) > 0
        for d in dets:
            assert set(d) == {"class_name", "bbox", "score"}
            assert d["class_name"] in classes and len(d["bbox"]) == 5
        first = next(c for c, d in enumerate(direct) if len(d))
        assert dets[0]["class_name"] == classes[first]
        np.testing.assert_allclose(dets[0]["bbox"], direct[first][0, :5],
                                   rtol=1e-6)

        # a png body goes through the image decoder to the same records
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(images[0]).save(buf, "PNG")
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.load(r) == dets

        # a malformed body is reported to the client, the server lives on
        req = urllib.request.Request(
            base + "/predict", data=b"not an array", method="POST",
            headers={"Content-Type": "application/x-npy"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        with urllib.request.urlopen(base + "/ping", timeout=10) as r:
            assert r.status == 200
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        handler.worker.shutdown()
    assert not thread.is_alive()


def test_entry_points_raise_without_a_card():
    """No device argument means the CUDA device; where there is none the
    entry point raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = {"model": {"type": "SphRetinaNet", "num_classes": 2,
                     "backbone": {"depth": 18}},
           "img_size": (64, 128), "bf16": False}
    with pytest.raises(RuntimeError, match="CUDA"):
        tapis.init_detector(cfg)
    with pytest.raises(NotImplementedError, match=r"model\.pth.*\.npz"):
        tapis.init_detector(cfg, "model.pth", device="cpu")

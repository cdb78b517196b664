"""Export of the PyTorch port against the JAX package's, on the CPU.

- the two custom ops (``torch.ops.sph_retina.sph2pob_iou_pairwise`` /
  ``_aligned``) take their plain versions on CPU tensors, bitwise, and
  their fake kernels give the output's shape and dtype;
- the greedy NMS as a ``while_loop`` keeps the old fixpoint loop's set and
  the JAX package's, with as many condition read-backs as the old loop's
  sweeps;
- the round trip: the shipped rotated config cut to R18 / 64x128 / fp32,
  one published ``.npz`` loaded by both packages, each package's artifact
  fed the same seeded float32 images at batch 2.

Tolerances between the packages are ``test_torch_serve_slice.py``'s, for
its reasons: labels, validity and counts exactly; scores 1e-4 absolute;
boxes 5e-3 degrees (1e-4 in the deltas times a large anchor's 50 degrees);
the seed has no deciding pair within 1e-4 of the NMS threshold, where the
JAX NMS's stacked ``sph_overlaps`` (1e-4 from the fused body) could flip a
decision. Within the port the artifact equals the live predict bitwise.
"""

import dataclasses
import io
import os
import zipfile

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from sph_retina_tpu import apis as japis
from sph_retina_tpu.boxes.nms import _greedy_suppress as jax_greedy
from sph_retina_tpu.engine.zoo import get_family as jax_get_family
from sph_retina_tpu.export import export_predict as jax_export_predict
from sph_retina_tpu.export import load_exported as jax_load_exported
from sph_retina_tpu.geometry import generate_boxes
from sph_retina_tpu.utils.publish import save_published
import sph_retina_tpu_torch
from sph_retina_tpu_torch import apis as tapis
from sph_retina_tpu_torch import export as texport
from sph_retina_tpu_torch.boxes import nms as tnms
from sph_retina_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from sph_retina_tpu_torch.ops import (
    sph2pob_iou_aligned,
    sph2pob_iou_aligned_plain,
    sph2pob_iou_pairwise,
    sph2pob_iou_pairwise_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs",
                      "sph_rotated_retinanet_r50_fpn_120e_pandora.py")
OPTIONS = ["model.backbone.depth=18", "img_size=(64,128)", "bf16=False"]
H, W = 64, 128
BOX_ATOL = 5e-3
# the images' seed: every deciding pair of its NMS lies more than 1e-4 from
# the threshold, which the round trip asserts
IMAGE_SEED = 4
PAIRWISE = torch.ops.sph_retina.sph2pob_iou_pairwise
ALIGNED = torch.ops.sph_retina.sph2pob_iou_aligned


# --------------------------------------------------------------------------- #
# (a), (b) the custom ops
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [4, 5])
@pytest.mark.parametrize("n, m", [(9, 7), (0, 7), (9, 0)])
def test_custom_ops_equal_their_plain_versions_on_the_cpu(d, n, m):
    b1 = torch.from_numpy(generate_boxes(n, d, seed=1))
    b2 = torch.from_numpy(generate_boxes(m, d, seed=2))
    got = PAIRWISE(b1, b2)
    assert got.shape == (n, m) and got.dtype == torch.float32
    assert torch.equal(got, sph2pob_iou_pairwise_plain(b1, b2))
    assert torch.equal(sph2pob_iou_pairwise(b1, b2), got)
    b3 = torch.from_numpy(generate_boxes(n, d, seed=3))
    got = ALIGNED(b1, b3)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert torch.equal(got, sph2pob_iou_aligned_plain(b1, b3))
    assert torch.equal(sph2pob_iou_aligned(b1, b3), got)


def test_fake_kernels_give_shape_and_dtype_and_opcheck_passes():
    with FakeTensorMode():
        b1, b2 = torch.empty((11, 5)), torch.empty((3, 5))
        pair, aligned = PAIRWISE(b1, b2), ALIGNED(b1, b1)
    assert pair.shape == (11, 3) and pair.dtype == torch.float32
    assert aligned.shape == (11,) and aligned.dtype == torch.float32
    b = torch.from_numpy(generate_boxes(6, 5, seed=4))
    torch.library.opcheck(PAIRWISE.default, (b, b[:4]))
    torch.library.opcheck(ALIGNED.default, (b, b.flip(0).contiguous()))


# --------------------------------------------------------------------------- #
# (c) the greedy suppression
# --------------------------------------------------------------------------- #
def fixpoint_loop(iou, valid, thr):
    """The port's greedy suppression before the ``while_loop``: a Python
    loop with one ``torch.equal`` read-back a sweep. Returns (keep,
    sweeps)."""
    k = iou.shape[0]
    dom = (iou > thr).triu(diagonal=1)
    keep, sweeps = valid, 0
    for _ in range(k + 1):
        new = valid & ~(dom & keep[:, None]).any(dim=0)
        sweeps += 1
        if torch.equal(new, keep):
            break
        keep = new
    return keep, sweeps


def _chain(k):
    """Box i suppresses box i + 1 for every i: k sweeps."""
    iou = np.zeros((k, k), np.float32)
    iou[np.arange(k - 1), np.arange(1, k)] = 0.9
    return iou, np.ones(k, bool)


def _seeded(k, seed):
    rng = np.random.default_rng(seed)
    iou = rng.random((k, k)).astype(np.float32) ** 4
    return iou, rng.random(k) > 0.2


@pytest.mark.parametrize("case", ["chain64", "k0", "k1", "k40", "k300"])
def test_while_loop_suppression_equals_the_old_loop_and_the_jax_one(
        case, monkeypatch):
    if case == "chain64":
        iou, valid = _chain(64)
    else:
        k = int(case[1:])
        iou, valid = _seeded(k, seed=k)
    conds = []
    real = tnms.while_loop_op

    def counting(cond, body, carried, additional):
        def counted(*args):
            conds.append(1)
            return cond(*args)
        return real(counted, body, carried, additional)

    monkeypatch.setattr(tnms, "while_loop_op", counting)
    t_iou, t_valid = torch.from_numpy(iou), torch.from_numpy(valid)
    got = tnms._greedy_suppress(t_iou, t_valid, 0.5)
    want, sweeps = fixpoint_loop(t_iou, t_valid, 0.5)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_greedy(iou, valid, 0.5)))
    assert len(conds) == sweeps  # one read-back a sweep, as before
    if case == "chain64":
        assert sweeps == 64 and got.numpy()[::2].all() \
            and not got.numpy()[1::2].any()


# --------------------------------------------------------------------------- #
# (d)-(f) the round trip
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jdet = japis.init_detector(CONFIG, cfg_options=OPTIONS, seed=0)
    # random init biases retina_cls to p ~ 0.01, below score_thr: raise it,
    # with seeded numpy values, so that well over nms_pre scores pass
    rng = np.random.default_rng(0)
    params = jax.device_get(jdet.variables["params"])
    head = dict(params["bbox_head"])
    head["retina_cls"] = dict(head["retina_cls"], bias=rng.normal(
        0.0, 1.0, head["retina_cls"]["bias"].shape).astype(np.float32))
    params = dict(params, bbox_head=head)
    path = save_published(
        str(tmp_path_factory.mktemp("ckpt") / "model.npz"), params,
        jax.device_get(jdet.variables["batch_stats"]), {"note": "test"})

    jdet = japis.init_detector(CONFIG, checkpoint=path, cfg_options=OPTIONS)
    # exact preselection on the JAX side (approx_max_k is a TPU device)
    jdet.det_cfg = dataclasses.replace(jdet.det_cfg, approx_topk=False)
    jdet.predict = jax_get_family(jdet.cfg).predict_fn(jdet.model,
                                                       jdet.det_cfg)
    tdet = tapis.init_detector(CONFIG, checkpoint=path, cfg_options=OPTIONS,
                               device="cpu")
    raw = np.random.default_rng(IMAGE_SEED).integers(
        0, 256, (2, H, W, 3)).astype(np.float32)
    images = ((raw - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    jax_out = jax_load_exported(jax_export_predict(jdet, batch_size=2))(
        images)
    blob = texport.export_predict(tdet, batch_size=2)
    return (tdet, blob, texport.load_exported(blob), images,
            tuple(np.asarray(o) for o in jax_out))


def _per_class(boxes, scores, labels, valid, num_classes):
    return [[np.concatenate([boxes[i][valid[i] & (labels[i] == c)],
                             scores[i][valid[i] & (labels[i] == c), None]], 1)
             for c in range(num_classes)] for i in range(boxes.shape[0])]


def test_artifact_equals_the_live_predict_and_the_jax_artifact(
        exported, monkeypatch):
    tdet, _, call, images, jax_out = exported
    assert call.meta == {"device": "cpu", "input_shape": [2, H, W, 3],
                         "input_dtype": "float32"}
    x = torch.from_numpy(images)
    got = call(x)

    margins = []
    greedy = tnms._greedy_suppress

    def recording(iou, valid, thr):
        """Distance to the threshold of the comparisons a flip of which
        would change the kept set (``test_torch_serve_slice.py``)."""
        keep = greedy(iou, valid, thr)
        by_kept = keep[:, None].expand_as(iou).triu(diagonal=1)
        below = torch.where(by_kept, thr - iou, torch.inf).amin(dim=0)
        above = torch.where(by_kept, iou - thr, -torch.inf).amax(dim=0)
        margins.append(float(torch.where(
            keep, below, torch.where(valid, above, torch.inf)).min()))
        return keep

    monkeypatch.setattr(tnms, "_greedy_suppress", recording)
    live = tdet.predict(x)
    for name, g, w in zip(live._fields, got, live):
        assert torch.equal(g, w), f"{name}: the artifact is not bitwise live"
    assert len(margins) == 2 and min(margins) > 1e-4, margins

    tb, ts, tl, _, tv = (t.numpy() for t in got)
    jb, js, jl, _, jv = jax_out
    assert tv.sum() > 20  # the NMS had real candidates
    np.testing.assert_array_equal(tv.sum(1), jv.sum(1))
    for t_img, j_img in zip(_per_class(tb, ts, tl, tv, 47),
                            _per_class(jb, js, jl, jv, 47)):
        for c, (t, j) in enumerate(zip(t_img, j_img)):
            assert t.shape == j.shape, (c, t.shape, j.shape)
            np.testing.assert_allclose(t[:, -1], j[:, -1], atol=1e-4, rtol=0)
            np.testing.assert_allclose(t[:, :-1], j[:, :-1], atol=BOX_ATOL,
                                       rtol=0)


def test_graph_holds_the_kernel_op_and_the_loop(exported):
    _, _, call, _, _ = exported
    targets = [str(n.target) for n in call.program.graph.nodes
               if n.op == "call_function"]
    # one IoU node and one suppression loop a image of the batch
    assert targets.count("sph_retina.sph2pob_iou_pairwise.default") == 2
    assert sum("while_loop" in t for t in targets) == 2
    assert not any("sph2pob_iou_pairwise_plain" in t for t in targets)


def test_export_bakes_weights(exported):
    """Another detector's weights give another artifact with other boxes:
    the weights are in the artifact (``tests/test_export.py``)."""
    _, _, call, images, _ = exported
    other = tapis.init_detector(CONFIG, cfg_options=OPTIONS, seed=1,
                                device="cpu")
    x = torch.from_numpy(images)
    b1 = call(x)[0]
    b2 = texport.load_exported(texport.export_predict(other, 2))(x)[0]
    assert not torch.allclose(b1, b2)


def test_artifact_runs_only_where_it_was_exported(exported):
    tdet, blob, _, _, _ = exported
    with pytest.raises(NotImplementedError, match="exported on"):
        texport.export_predict(tdet, platforms=["cuda"])
    # the same artifact as if exported on a card
    src, dst = zipfile.ZipFile(io.BytesIO(blob)), io.BytesIO()
    with zipfile.ZipFile(dst, "w") as out:
        for item in src.infolist():
            data = src.read(item)
            if item.filename.endswith("sph_retina_meta.json"):
                data = data.replace(b'"cpu"', b'"cuda"')
            out.writestr(item, data)
    assert texport.artifact_meta(dst.getvalue())["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            texport.load_exported(dst.getvalue())


def test_package_exports_the_jax_packages_export_names():
    from sph_retina_tpu import export as jexport

    assert set(jexport.__all__) <= set(texport.__all__)
    for name in jexport.__all__:
        assert getattr(sph_retina_tpu_torch, name) is getattr(texport, name)

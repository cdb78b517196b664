"""The port's ``parallel/sharding.py`` across processes, on the CPU: FSDP
(ZeRO-3) over "data", the width-sharded "space" axis with the split
RetinaNet and FCOS heads, both at once, and the row-sharded pairwise
overlaps.

gloo jobs of ``tests/utils/torch_ranks.py`` (which imports the port and
never JAX), started as ``tests/test_torch_parallel_ranks.py`` starts its own
and under its rules: a log file a rank, every wait <= ``WAIT_S``,
everything written removed once the module is done. Five jobs run at once:
data 2 (FSDP), two of data 1 x space 2, data 2 x space 2 with FSDP (4
ranks), and the port's one-process reference at the ranks' one thread;
meanwhile this process jits the JAX package's one-device steps (three
threads).

Checked, R18 in fp32 as ``tests/test_sharding.py`` runs the JAX package's
mesh, with the JAX tests' tolerances:

- a RetinaNet step at 64x128, FSDP over 2 ranks, against the JAX package's
  one-device step from the same weights (``to_flax``): loss ``rtol=1e-4``,
  gradients ``rtol=1e-3, atol=1e-5``, parameters after the update
  ``atol=1e-5``; a large leaf sharded before and after the step;
- the same step over data 1 x space 2 through the split head (its P7 is 1
  column wide: narrow, owned by rank 0), and a step at 64x256, where every
  level splits, against the JAX step at that size: loss ``rtol=1e-4``,
  gradients as above; over data 2 x space 2 with FSDP, loss ``rtol=1e-3``;
- each space rank's K1 input ``(B * G, N_rank)`` with its own anchors
  (``N / 2`` at 64x256), its head's input widths, and the two ranks'
  labels and positives joined equal to one process's exactly, on a batch
  with a GT whose best anchors lie on rank 1 alone below ``pos_iou_thr``
  (the low-quality rescue across ranks);
- ``sharded_pairwise_overlaps`` at 61 x 7 rows D=4 over 2 ranks (the pad
  path): bitwise the unsharded ``sph_overlaps``, and within C7's gap
  (4.7e-5 at D=4) of the JAX function on its 8-device CPU mesh;
- FCOS and Faster R-CNN (OHEM) gradients of one FSDP and of one space step,
  and SSD's of one space step, against the port's one-process step,
  ``rtol=1e-3, atol=1e-5`` (SSD and Faster R-CNN on the gathered head);
  FCOS's space step also against the JAX package's one-device step (with
  ``SphL1Loss``: the JAX step of the default ``SphIoULoss`` takes minutes
  to compile on the CPU);
- a space step on a batch without positives (the normalisers' clamp)
  against one process; the decoded-box positive gather on a split head
  within its budget and past it: one process's rows, losses, gradients
  and ``metric_pos_dropped``;
- the predict of a partitioned RetinaNet and FCOS on whole images: one
  process's detections;
- a checkpoint of the FSDP job loads into a one-process model, and a
  one-process checkpoint into the sharded state.
"""

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sph_retina_tpu.engine.builder import build_tx as jax_build_tx
from sph_retina_tpu.engine.zoo import get_family as jax_get_family
from sph_retina_tpu.geometry import generate_boxes
from sph_retina_tpu.models import single_stage as jss
from sph_retina_tpu.parallel import make_mesh as jax_make_mesh
from sph_retina_tpu.parallel import (
    sharded_pairwise_overlaps as jax_sharded_overlaps,
)
from sph_retina_tpu.utils.config import apply_overrides as jax_overrides
from sph_retina_tpu.utils.config import load_config as jax_load_config
from sph_retina_tpu_torch import parallel
from sph_retina_tpu_torch.data import (
    DataLoader,
    SphPipeline,
    make_synthetic_dataset,
)
from sph_retina_tpu_torch.engine.builder import build_tx
from sph_retina_tpu_torch.engine.runner import Checkpointer, load_checkpoint
from sph_retina_tpu_torch.engine.zoo import get_family
from sph_retina_tpu_torch.models import single_stage as tss
from sph_retina_tpu_torch.models.from_flax import to_flax
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config

from test_torch_assign_loss import port_iou_callback
from test_torch_parallel_ranks import (
    FAMILY_CONFIGS,
    REPO,
    RETINA_CFG,
    SMALL,
    Job,
    _batch,
    _close,
    _save_model,
)

C7_GAP_D4 = 4.7e-5  # ROADMAP C7: sph2pob_efficient, JAX against the port
LARGE_LEAF = "neck.fpn_conv_0.weight"  # (256, 256, 3, 3): cut on dim 0
WIDE = (64, 256)
RESCUED_GT = (270.0, 90.0, 50.0, 6.0, 0.0)
DECODED = ["model.reg_decoded_bbox=True",
           "model.loss_bbox={'type': 'Sph2PobIoULoss'}"]
# the JAX package's FCOS step with its default SphIoULoss takes minutes to
# compile on the CPU; with SphL1Loss, seconds (the split head is the same)
FCOS_L1 = ["model.loss_bbox={'type': 'SphL1Loss'}"]


def _jax_reference(cfg_path, options, weights, batch):
    """The JAX package's one-device step on the whole batch: its loss, its
    gradients and its parameters after the update, from the port's weights
    (``to_flax``). Its assigner sees the port's overlaps (``_port_iou``)."""
    jcfg = jax_overrides(jax_load_config(str(cfg_path)), options)
    jfam = jax_get_family(jcfg)
    jmodel, jdet = jfam.build(jcfg)
    params, stats = to_flax(torch.load(weights))
    loss = jfam.loss_fn(jmodel, jdet)
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("images", "gt_boxes", "gt_labels", "gt_mask")}
    (total, _), grads = jax.jit(jax.value_and_grad(
        lambda p: loss({"params": p, "batch_stats": stats}, jbatch, None),
        has_aux=True))(params)
    tx = jax_build_tx(jcfg, steps_per_epoch=1)
    updates, _ = tx.update(grads, tx.init(params), params)
    return (float(total), jax.device_get(grads),
            jax.device_get(optax.apply_updates(params, updates)))


def _port_iou(*cfg_paths):
    """A stand-in for the JAX package's ``_batch_pairwise_iou`` that asks the
    port for the overlaps against its anchors of the same count (one patch
    for the JAX steps of several image sizes, traced side by side)."""
    calls = {}
    for path in cfg_paths:
        cfg = load_config(str(path))
        anchors = get_family(cfg).build(cfg)[1].flat_anchors()
        calls[anchors.shape[0]] = port_iou_callback(anchors)
    return lambda gt, anchors, backend: calls[anchors.shape[0]](
        gt, anchors, backend)


def _wide_batch() -> dict:
    """2 images at 64x256; image 1 also holds a flat GT far into rank 1's
    half, whose best anchors (IoU ~0.07) all lie in rank 1's columns."""
    ds = make_synthetic_dataset(n_images=2, num_classes=7, img_size=WIDE,
                                box_version=5, seed=2)
    pipe = SphPipeline(img_size=WIDE, max_gt=8, box_version=5)
    batch = next(DataLoader(ds, pipe, batch_size=2, shuffle=False).epoch(0))
    slot = int(batch["gt_mask"][1].sum())
    batch["gt_boxes"][1, slot] = RESCUED_GT
    batch["gt_labels"][1, slot] = 3
    batch["gt_mask"][1, slot] = True
    return batch


def _one_process_checkpoint(cfg_path, weights, directory) -> str:
    """A checkpoint of one process whose optimiser state is not its start
    (seeded momentum buffers and EMA shadows, count 3)."""
    cfg = load_config(str(cfg_path))
    model = get_family(cfg).build(cfg)[0]
    model.load_state_dict(torch.load(weights))
    optimizer = build_tx(cfg, model, steps_per_epoch=1)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for t in optimizer.bufs + optimizer.ema:
            t.add_(torch.randn(t.shape, generator=gen))
    optimizer.count = 3
    return Checkpointer(str(directory)).save(model, optimizer, 3)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    jobs = []
    try:
        retina_cfg = root / "retina.py"
        retina_cfg.write_text(RETINA_CFG)
        wide_cfg = root / "retina_wide.py"
        wide_cfg.write_text(RETINA_CFG.replace("img_size = (64, 128)",
                                               f"img_size = {WIDE}"))
        retina_batch = _batch(5, 7, seed=2)
        np.savez(root / "batch5.npz", **retina_batch)
        np.savez(root / "nopos.npz", **dict(
            retina_batch, gt_mask=np.zeros_like(retina_batch["gt_mask"])))
        np.savez(root / "batch2.npz", **{k: v[:2] for k, v in
                                          retina_batch.items()})
        wide_batch = _wide_batch()
        np.savez(root / "wide.npz", **wide_batch)
        _save_model(load_config(str(retina_cfg)), root / "retina.pt")

        def retina(config, batch, options=()):
            return {"config": str(config), "options": list(options),
                    "weights": str(root / "retina.pt"),
                    "batch": str(root / batch)}

        models = {"retina": retina(retina_cfg, "batch5.npz"),
                  "retina_nopos": retina(retina_cfg, "nopos.npz"),
                  "retina_wide": retina(wide_cfg, "wide.npz"),
                  "retina_decoded": retina(retina_cfg, "batch2.npz",
                                           DECODED),
                  "retina_topk": retina(retina_cfg, "batch2.npz", DECODED
                                        + ["model.loss_pos_topk=2"]),
                  # 200 candidates a level: the CPU's greedy NMS is slow
                  "retina_nms200": retina(retina_cfg, "batch2.npz",
                                           ["test_cfg.nms_pre=200"])}
        np.savez(root / "batch4.npz", **_batch(4, 3, seed=3))
        for name in ("fcos", "frcnn", "ssd"):
            path = os.path.join(REPO, "configs", FAMILY_CONFIGS[name])
            _save_model(apply_overrides(load_config(path), SMALL),
                        root / f"{name}.pt")
            models[name] = {"config": path, "options": SMALL,
                            "weights": str(root / f"{name}.pt"),
                            "batch": str(root / "batch4.npz")}
        models["fcos_l1"] = dict(models["fcos"], options=SMALL + FCOS_L1)
        np.savez(root / "boxes.npz", b1=generate_boxes(61, 4, seed=1),
                 b2=generate_boxes(7, 4, seed=2))
        one_ckpt = _one_process_checkpoint(retina_cfg, root / "retina.pt",
                                           root / "one_ckpt")
        fsdp = Job("fsdp", "sharded", {"models": models, "runs": [
            {"name": "retina_fsdp", "model": "retina", "space": 1,
             "fsdp": True, "save": str(root / "fsdp_ckpt")},
            {"name": "retina_fsdp_load", "model": "retina", "space": 1,
             "fsdp": True, "load": one_ckpt},
            {"name": "fcos_fsdp", "model": "fcos", "space": 1, "fsdp": True},
            {"name": "frcnn_fsdp", "model": "frcnn", "space": 1,
             "fsdp": True},
            {"name": "overlaps", "space": 1,
             "overlaps": str(root / "boxes.npz")}]}, root)
        space = Job("space", "sharded", {"models": models, "runs": [
            {"name": f"{name}_space", "model": name, "space": 2}
            for name in ("retina", "retina_nopos", "fcos", "frcnn",
                         "ssd")]}, root)
        split = Job("split", "sharded", {"models": models, "runs": [
            {"name": f"{name}_space", "model": name, "space": 2}
            for name in ("retina_wide", "retina_decoded", "retina_topk",
                         "fcos_l1")] + [
            {"name": f"{name}_predict", "model": model, "space": 2,
             "predict": True} for name, model in (("retina", "retina_nms200"),
                                                  ("fcos", "fcos"))]}, root)
        both = Job("both", "sharded", {"models": models, "runs": [
            {"name": "retina_both", "model": "retina", "space": 2,
             "fsdp": True}]}, root, world=4)
        world_one = root / "world_one"
        world_one.mkdir()
        one_models = ("retina_nopos", "retina_decoded", "retina_topk",
                      "fcos", "frcnn", "ssd")
        one = Job("one", "steps", {"models": {
            k: models[k] for k in one_models}}, world_one, world=1)
        jobs += [fsdp, space, split, both, one]

        # meanwhile, in this process: the JAX references and the
        # one-process predict
        t0 = time.monotonic()
        fcos_path = os.path.join(REPO, "configs", FAMILY_CONFIGS["fcos"])
        with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(3) as ex:
            mp.setattr(jss, "_batch_pairwise_iou",
                       _port_iou(retina_cfg, wide_cfg))
            refs = {name: ex.submit(_jax_reference, *args) for name, args in (
                ("retina", (retina_cfg, [], root / "retina.pt",
                            retina_batch)),
                ("retina_wide", (wide_cfg, [], root / "retina.pt",
                                 wide_batch)),
                ("fcos_l1", (fcos_path, SMALL + FCOS_L1, root / "fcos.pt",
                          dict(np.load(root / "batch4.npz")))))}
            refs = {k: f.result() for k, f in refs.items()}
        with np.load(root / "boxes.npz") as f:
            jax_iou = np.asarray(jax_sharded_overlaps(
                jnp.asarray(f["b1"]), jnp.asarray(f["b2"]),
                jax_make_mesh(8)))
        predicted = {name: _one_process_predict(models[model])
                     for name, model in (("retina", "retina_nms200"),
                                         ("fcos", "fcos"))}
        jax_s = time.monotonic() - t0
        said = {job.name: job.finish() for job in jobs}
        print(f"JAX references {jax_s:.1f} s;",
              {k: [r["seconds"] for r in v] for k, v in said.items()})
        yield dict(
            root=root, jax=refs, jax_iou=jax_iou, one_ckpt=one_ckpt,
            models=models, wide_batch=wide_batch, predicted=predicted,
            out={p[:-3]: torch.load(root / p)
                 for p in os.listdir(root) if p.endswith(".pt")
                 and p[:-3] not in models},
            one={k: torch.load(world_one / f"{k}_rank0.pt")
                 for k in one_models})
    finally:
        for job in jobs:
            job.kill()
        shutil.rmtree(root, ignore_errors=True)


def _one_process_predict(spec: dict) -> dict:
    cfg = apply_overrides(load_config(spec["config"]), spec["options"])
    family = get_family(cfg)
    model, det_cfg = family.build(cfg)
    model.load_state_dict(torch.load(spec["weights"]))
    with np.load(spec["batch"]) as f:
        images = torch.from_numpy(f["images"])
    return family.predict_fn(model, det_cfg)(images)._asdict()


def test_fsdp_step_equals_the_jax_single_device_step(sharded):
    run = sharded["out"]["retina_fsdp"]
    jax_loss, jgrads, jparams = sharded["jax"]["retina"]
    np.testing.assert_allclose(run["metrics"]["loss"], jax_loss, rtol=1e-4)
    _close(run["grads"], jgrads, rtol=1e-3, atol=1e-5)
    _close(run["params"], jparams, atol=1e-5, rtol=0)
    full = tuple(run["params"][LARGE_LEAF].shape)
    want = (full[0] // 2,) + full[1:]
    assert run["shapes_before"][LARGE_LEAF] == want
    assert run["shapes_after"][LARGE_LEAF] == want


@pytest.mark.parametrize("name, neck, head", [
    # P3..P7 of a 128-wide chart over 2 space ranks: P7 does not split
    ("retina", [16, 8, 4, 2, 1], [16, 8, 4, 2, 1]),
    ("retina_wide", [32, 16, 8, 4, 2], [32, 16, 8, 4, 2])])
def test_space_step_equals_the_jax_single_device_step(sharded, name, neck,
                                                      head):
    run = sharded["out"][f"{name}_space"]
    jax_loss, jgrads, _ = sharded["jax"][name]
    assert run["neck_widths"] == neck
    for r in range(2):
        assert sharded["out"][f"{name}_space_seen{r}"]["head_widths"] == head
    np.testing.assert_allclose(run["metrics"]["loss"], jax_loss, rtol=1e-4)
    _close(run["grads"], jgrads, rtol=1e-3, atol=1e-5)
    assert run["shapes_after"][LARGE_LEAF] == tuple(
        run["params"][LARGE_LEAF].shape)


def test_fsdp_and_space_on_four_ranks(sharded):
    run = sharded["out"]["retina_both"]
    np.testing.assert_allclose(run["metrics"]["loss"],
                               sharded["jax"]["retina"][0], rtol=1e-3)
    assert run["shapes_after"][LARGE_LEAF][0] * 2 == \
        run["params"][LARGE_LEAF].shape[0]


def _one_process_targets(sharded, name):
    spec = sharded["models"][name]
    cfg = load_config(spec["config"])
    det_cfg = get_family(cfg).build(cfg)[1]
    with np.load(spec["batch"]) as f:
        gt = [torch.from_numpy(f[k])
              for k in ("gt_boxes", "gt_labels", "gt_mask")]
    return det_cfg, gt, tss.anchor_targets(det_cfg, det_cfg.flat_anchors(),
                                           *gt)


@pytest.mark.parametrize("name", ["retina", "retina_wide"])
def test_split_assignment_equals_one_process(sharded, name):
    """Each rank's K1 input is ``(B * G, N_rank)`` with its own anchors;
    the ranks' labels joined, and their positives summed, are one
    process's, exactly."""
    det_cfg, gt, want = _one_process_targets(sharded, name)
    anchors = det_cfg.flat_anchors()
    n, bg = anchors.shape[0], gt[0].shape[0] * gt[0].shape[1]
    labels = torch.full_like(want.labels, -2)
    num_pos = 0
    for r in range(2):
        seen = sharded["out"][f"{name}_space_seen{r}"]
        part = parallel.head_part(det_cfg.featmap_sizes(),
                                  det_cfg.anchor_generator.num_base_anchors,
                                  2, r)
        (assign,) = seen["assign"]
        assert seen["k1_inputs"] == [((bg, 5), (len(part.indices), 5))]
        assert torch.equal(assign["anchors"], anchors[part.indices])
        labels[:, part.indices] = assign["labels"]
        num_pos += assign["num_pos"]
        if name == "retina_wide":  # every level splits
            assert len(part.indices) * 2 == n
    assert torch.equal(labels, want.labels)
    assert num_pos == int(want.num_pos)


def test_the_low_quality_rescue_crosses_ranks(sharded):
    """The wide batch separates: its flat GT's best anchors lie on rank 1
    alone, below ``pos_iou_thr``, and rank 0 holds smaller overlaps of it;
    rank 0's assignment with its own each-gt maximum (no all-reduce) claims
    other anchors than one process's."""
    det_cfg, gt, want = _one_process_targets(sharded, "retina_wide")
    anchors = det_cfg.flat_anchors()
    slot = int(gt[2][1].sum()) - 1
    assert tuple(gt[0][1, slot].tolist()) == RESCUED_GT
    overlaps = tss._batch_pairwise_iou(gt[0], anchors, "sph2pob_efficient")
    iou = overlaps[1, slot]
    parts = [parallel.head_part(det_cfg.featmap_sizes(),
                                det_cfg.anchor_generator.num_base_anchors,
                                2, r) for r in range(2)]
    best = (iou == iou.max()).nonzero().flatten()
    assert float(iou.max()) < det_cfg.assigner.pos_iou_thr
    assert bool(torch.isin(best, parts[1].indices).all())
    assert 0 < float(iou[parts[0].indices].max()) < float(iou.max())
    assert bool((want.labels[1, best] == 3).all())
    local = det_cfg.assigner(overlaps[..., parts[0].indices], gt[2], gt[1])
    got = sharded["out"]["retina_wide_space_seen0"]["assign"][0]["labels"]
    assert not torch.equal(torch.where(local.gt_inds > 0, local.labels,
                                       det_cfg.num_classes), got)
    assert torch.equal(got, want.labels[:, parts[0].indices])


def test_sharded_overlaps(sharded):
    run = sharded["out"]["overlaps"]
    assert run["got"].shape == (61, 7)
    assert torch.equal(run["got"], run["want"])  # rows are independent
    np.testing.assert_allclose(run["got"].numpy(), sharded["jax_iou"],
                               rtol=0, atol=C7_GAP_D4)


@pytest.mark.parametrize("name", ["fcos_fsdp", "fcos_space", "frcnn_fsdp",
                                  "frcnn_space", "ssd_space"])
def test_family_gradients_equal_one_process(sharded, name):
    got = sharded["out"][name]["grads"]
    want = sharded["one"][name.split("_")[0]]["grads"]
    assert got.keys() == want.keys()
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    assert any(float(g.abs().max()) > 1e-3 for g in want.values())


def test_fcos_space_step_equals_the_jax_single_device_step(sharded):
    run = sharded["out"]["fcos_l1_space"]
    jax_loss, jgrads, _ = sharded["jax"]["fcos_l1"]
    assert run["neck_widths"] == [16, 8, 4, 2, 1]
    np.testing.assert_allclose(run["metrics"]["loss"], jax_loss, rtol=1e-4)
    _close(run["grads"], jgrads, rtol=1e-3, atol=1e-5)


def test_space_step_without_positives_equals_one_process(sharded):
    run = sharded["out"]["retina_nopos_space"]
    want = sharded["one"]["retina_nopos"]
    np.testing.assert_allclose(run["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=1e-4)
    assert run["metrics"]["loss_bbox"] == want["metrics"]["loss_bbox"] == 0
    for k, g in want["grads"].items():
        np.testing.assert_allclose(run["grads"][k].numpy(), g.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name, dropped", [("retina_decoded", False),
                                           ("retina_topk", True)])
def test_positive_gather_equals_one_process(sharded, name, dropped):
    """Within its budget, and past it (K=2 a image: 4 of the 2 images'
    positives kept, the rest dropped), the two ranks keep one process's
    rows together: the same losses, gradients and ``metric_pos_dropped``."""
    run = sharded["out"][f"{name}_space"]
    want = sharded["one"][name]
    assert (want["metrics"]["metric_pos_dropped"] > 4) == dropped
    assert run["metrics"]["metric_pos_dropped"] == \
        want["metrics"]["metric_pos_dropped"]
    for k in ("loss", "loss_cls", "loss_bbox"):
        np.testing.assert_allclose(run["metrics"][k], want["metrics"][k],
                                   rtol=1e-4, err_msg=k)
    for k, g in want["grads"].items():
        np.testing.assert_allclose(run["grads"][k].numpy(), g.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["retina", "fcos"])
def test_predict_on_a_partitioned_model_gives_one_process(sharded, name):
    got = sharded["out"][f"{name}_predict"]["detections"]
    want = sharded["predicted"][name]
    assert torch.equal(got["valid"], want["valid"])
    assert int(want["valid"].sum()) > 0
    for k in ("labels", "inds"):
        assert torch.equal(got[k][want["valid"]], want[k][want["valid"]]), k
    # the head's outputs agree to ~1e-6; the boxes' decode (an exp of the
    # deltas) carries that to ~3e-4 relative in degrees
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=k)


def test_fsdp_checkpoint_loads_into_one_process(sharded):
    run = sharded["out"]["retina_fsdp"]
    cfg = load_config(str(sharded["root"] / "retina.py"))
    model = get_family(cfg).build(cfg)[0]
    optimizer = build_tx(cfg, model, steps_per_epoch=1)
    assert load_checkpoint(str(sharded["root"] / "fsdp_ckpt"), model,
                           optimizer) == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, run["params"][k]), k
    state = optimizer.state_dict()
    for part in ("momentum_buffers", "ema"):
        for k, v in state[part].items():
            assert torch.equal(v, run["optimizer"][part][k]), (part, k)


def test_one_process_checkpoint_loads_into_the_sharded_state(sharded):
    run = sharded["out"]["retina_fsdp_load"]
    want = torch.load(sharded["one_ckpt"])
    assert run["shapes"][LARGE_LEAF][0] * 2 == \
        want["model"][LARGE_LEAF].shape[0]
    for k, v in want["model"].items():
        assert torch.equal(run["model"][k], v), k
    assert run["optimizer"]["count"] == 3
    for part in ("momentum_buffers", "ema"):
        for k, v in want["optimizer"][part].items():
            assert torch.equal(run["optimizer"][part][k], v), (part, k)

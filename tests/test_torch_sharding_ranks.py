"""The port's ``parallel/sharding.py`` across processes, on the CPU: FSDP
(ZeRO-3) over "data", the width-sharded "space" axis, both at once, and the
row-sharded pairwise overlaps.

gloo jobs of ``tests/utils/torch_ranks.py`` (which imports the port and
never JAX), started as ``tests/test_torch_parallel_ranks.py`` starts its own
and under its rules: a log file a rank, every wait <= ``WAIT_S``,
everything written removed once the module is done. Four jobs run at once:
data 2 (FSDP), data 1 x space 2, data 2 x space 2 with FSDP (4 ranks), and
the port's one-process reference at the ranks' one thread; meanwhile this
process jits the JAX package's one-device step once.

Checked, R18 at 64x128 in fp32 as ``tests/test_sharding.py`` runs the JAX
package's mesh, with the JAX tests' tolerances:

- a RetinaNet step, FSDP over 2 ranks, against the JAX package's
  one-device step from the same weights (``to_flax``): loss ``rtol=1e-4``,
  gradients ``rtol=1e-3, atol=1e-5``, parameters after the update
  ``atol=1e-5``; a large leaf sharded before and after the step;
- the same step over data 1 x space 2 (its P7 is 1 column wide: the narrow
  path), loss ``rtol=1e-4``, gradients as above; over data 2 x space 2 with
  FSDP, loss ``rtol=1e-3``;
- ``sharded_pairwise_overlaps`` at 61 x 7 rows D=4 over 2 ranks (the pad
  path): bitwise the unsharded ``sph_overlaps``, and within C7's gap
  (4.7e-5 at D=4) of the JAX function on its 8-device CPU mesh;
- FCOS and Faster R-CNN (OHEM) gradients of one FSDP and of one space step
  against the port's one-process step, ``rtol=1e-3, atol=1e-5``;
- a space step on a batch without positives (the normalisers' clamp)
  against one process;
- a checkpoint of the FSDP job loads into a one-process model, and a
  one-process checkpoint into the sharded state.
"""

import os
import shutil

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
from sph_retina_tpu.utils.config import load_config as jax_load_config
from sph_retina_tpu_torch.engine.builder import build_tx
from sph_retina_tpu_torch.engine.runner import Checkpointer, load_checkpoint
from sph_retina_tpu_torch.engine.zoo import get_family
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


def _jax_reference(cfg_path, weights, batch):
    """The JAX package's one-device step on the whole batch: its loss, its
    gradients and its parameters after the update, from the port's weights
    (``to_flax``); both assigners see the port's overlaps."""
    jcfg = jax_load_config(str(cfg_path))
    jfam = jax_get_family(jcfg)
    jmodel, jdet = jfam.build(jcfg)
    params, stats = to_flax(torch.load(weights))
    loss = jfam.loss_fn(jmodel, jdet)
    tcfg = load_config(str(cfg_path))
    anchors = get_family(tcfg).build(tcfg)[1].flat_anchors()
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("images", "gt_boxes", "gt_labels", "gt_mask")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jss, "_batch_pairwise_iou", port_iou_callback(anchors))
        (total, _), grads = jax.jit(jax.value_and_grad(
            lambda p: loss({"params": p, "batch_stats": stats}, jbatch,
                           None), has_aux=True))(params)
    tx = jax_build_tx(jcfg, steps_per_epoch=1)
    updates, _ = tx.update(grads, tx.init(params), params)
    return (float(total), jax.device_get(grads),
            jax.device_get(optax.apply_updates(params, updates)))


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
        retina_batch = _batch(5, 7, seed=2)
        np.savez(root / "batch5.npz", **retina_batch)
        np.savez(root / "nopos.npz", **dict(
            retina_batch, gt_mask=np.zeros_like(retina_batch["gt_mask"])))
        _save_model(load_config(str(retina_cfg)), root / "retina.pt")
        models = {name: {"config": str(retina_cfg), "options": [],
                         "weights": str(root / "retina.pt"),
                         "batch": str(root / batch)}
                  for name, batch in (("retina", "batch5.npz"),
                                      ("retina_nopos", "nopos.npz"))}
        np.savez(root / "batch4.npz", **_batch(4, 3, seed=3))
        for name in ("fcos", "frcnn"):
            path = os.path.join(REPO, "configs", FAMILY_CONFIGS[name])
            _save_model(apply_overrides(load_config(path), SMALL),
                        root / f"{name}.pt")
            models[name] = {"config": path, "options": SMALL,
                            "weights": str(root / f"{name}.pt"),
                            "batch": str(root / "batch4.npz")}
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
            for name in ("retina", "retina_nopos", "fcos", "frcnn")]}, root)
        both = Job("both", "sharded", {"models": models, "runs": [
            {"name": "retina_both", "model": "retina", "space": 2,
             "fsdp": True}]}, root, world=4)
        world_one = root / "world_one"
        world_one.mkdir()
        one = Job("one", "steps", {"models": {
            k: models[k] for k in ("retina_nopos", "fcos", "frcnn")}},
            world_one, world=1)
        jobs += [fsdp, space, both, one]

        # meanwhile, in this process: the JAX references
        jax_loss, jgrads, jparams = _jax_reference(
            retina_cfg, root / "retina.pt", retina_batch)
        with np.load(root / "boxes.npz") as f:
            jax_iou = np.asarray(jax_sharded_overlaps(
                jnp.asarray(f["b1"]), jnp.asarray(f["b2"]),
                jax_make_mesh(8)))
        said = {job.name: job.finish() for job in jobs}
        print({k: [r["seconds"] for r in v] for k, v in said.items()})
        yield dict(
            root=root, jax_loss=jax_loss, jgrads=jgrads, jparams=jparams,
            jax_iou=jax_iou, one_ckpt=one_ckpt,
            out={p[:-3]: torch.load(root / p)
                 for p in os.listdir(root) if p.endswith(".pt")
                 and p[:-3] not in models},
            one={k: torch.load(world_one / f"{k}_rank0.pt")
                 for k in ("retina_nopos", "fcos", "frcnn")})
    finally:
        for job in jobs:
            job.kill()
        shutil.rmtree(root, ignore_errors=True)


def test_fsdp_step_equals_the_jax_single_device_step(sharded):
    run = sharded["out"]["retina_fsdp"]
    np.testing.assert_allclose(run["metrics"]["loss"], sharded["jax_loss"],
                               rtol=1e-4)
    _close(run["grads"], sharded["jgrads"], rtol=1e-3, atol=1e-5)
    _close(run["params"], sharded["jparams"], atol=1e-5, rtol=0)
    full = tuple(run["params"][LARGE_LEAF].shape)
    want = (full[0] // 2,) + full[1:]
    assert run["shapes_before"][LARGE_LEAF] == want
    assert run["shapes_after"][LARGE_LEAF] == want


def test_space_step_equals_the_jax_single_device_step(sharded):
    run = sharded["out"]["retina_space"]
    # P3..P7 of a 128-wide chart over 2 space ranks: P7 does not split
    assert run["neck_widths"] == [16, 8, 4, 2, 1]
    np.testing.assert_allclose(run["metrics"]["loss"], sharded["jax_loss"],
                               rtol=1e-4)
    _close(run["grads"], sharded["jgrads"], rtol=1e-3, atol=1e-5)
    assert run["shapes_after"][LARGE_LEAF] == tuple(
        run["params"][LARGE_LEAF].shape)


def test_fsdp_and_space_on_four_ranks(sharded):
    run = sharded["out"]["retina_both"]
    np.testing.assert_allclose(run["metrics"]["loss"], sharded["jax_loss"],
                               rtol=1e-3)
    assert run["shapes_after"][LARGE_LEAF][0] * 2 == \
        run["params"][LARGE_LEAF].shape[0]


def test_sharded_overlaps(sharded):
    run = sharded["out"]["overlaps"]
    assert run["got"].shape == (61, 7)
    assert torch.equal(run["got"], run["want"])  # rows are independent
    np.testing.assert_allclose(run["got"].numpy(), sharded["jax_iou"],
                               rtol=0, atol=C7_GAP_D4)


@pytest.mark.parametrize("name", ["fcos_fsdp", "fcos_space", "frcnn_fsdp",
                                  "frcnn_space"])
def test_family_gradients_equal_one_process(sharded, name):
    got = sharded["out"][name]["grads"]
    want = sharded["one"][name.split("_")[0]]["grads"]
    assert got.keys() == want.keys()
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    assert any(float(g.abs().max()) > 1e-3 for g in want.values())


def test_space_step_without_positives_equals_one_process(sharded):
    run = sharded["out"]["retina_nopos_space"]
    want = sharded["one"]["retina_nopos"]
    np.testing.assert_allclose(run["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=1e-4)
    assert run["metrics"]["loss_bbox"] == want["metrics"]["loss_bbox"] == 0
    for k, g in want["grads"].items():
        np.testing.assert_allclose(run["grads"][k].numpy(), g.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=k)


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

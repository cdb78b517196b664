"""The port's ``parallel/sharding.py`` in one process, on the CPU (no
subprocess; several ranks are ``test_torch_sharding_ranks.py``'s job).

- ``fsdp_spec`` equals the JAX function on the JAX test's cases
  (``tests/test_sharding.py:59-68``) and on every Flax leaf of R18
  RetinaNet at axis sizes 2, 4 and 8; the torch dimension that
  ``shard_state_fsdp`` cuts is the counterpart of the JAX choice: each
  piece, carried to the Flax layout by ``to_flax``, is the JAX piece.
- ``make_mesh(8, space=3)`` raises ``ValueError`` before any group is
  touched; ``n_devices`` other than the group's size raises.
- ``batch_specs`` equals the JAX function's (the port's batches are NHWC,
  as the JAX package's); ``shard_batch_spatial``'s parts of a (4 data x 2
  space) mesh reassemble the batch.
- The halo of every windowed op, by op, on a port RetinaNet and SSD.
- ``head_part`` at 512x1024 and 64x128 over 2 and 4 space ranks: each
  rank's anchors (RetinaNet) and points (FCOS) are disjoint, cover every
  one once (a narrow level's on rank 0 alone), lie in the rank's columns,
  and come in the order of the head's own local outputs (the real heads'
  permute and reshape, fed a grid of indices).
- The positive gather keeps, of equal weights, the rows ``jax.lax.top_k``
  keeps (the lower ones).
- In a gloo group of one (``file://`` store, removed after): a (1, 1) mesh
  leaves the model and the state as they are, a step bit for bit that of
  an unsharded model, and ``sharded_pairwise_overlaps`` is
  ``sph_overlaps``.
"""

import types

import jax
import numpy as np
import pytest
import torch
from torch import nn

from sph_retina_tpu.geometry import generate_boxes
from sph_retina_tpu.parallel import batch_specs as jax_batch_specs
from sph_retina_tpu.parallel import fsdp_spec as jax_fsdp_spec
from sph_retina_tpu.parallel import make_mesh as jax_make_mesh
from sph_retina_tpu_torch import parallel
from sph_retina_tpu_torch.engine.builder import build_tx
from sph_retina_tpu_torch.engine.zoo import get_family, make_generic_train_step
from sph_retina_tpu_torch.iou.api import sph_overlaps
from sph_retina_tpu_torch.models.fcos import SphFCOSHead, fcos_config
from sph_retina_tpu_torch.models.from_flax import to_flax
from sph_retina_tpu_torch.models.heads.retina_head import SphRetinaHead
from sph_retina_tpu_torch.models.resnet import Conv2d, MaxPool2d
from sph_retina_tpu_torch.models.single_stage import (
    SphRetinaNet,
    _pos_gather,
    retina_config,
)
from sph_retina_tpu_torch.models.ssd import SphSSD
from sph_retina_tpu_torch.utils.config import apply_overrides, load_config

from utils.process_group import gloo_world_of_one

JAX_CASES = [((3, 3, 64, 128), 8), ((256, 7), 8), ((7,), 8), ((), 8),
             ((64,), 1)]


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def r18():
    return SphRetinaNet(num_classes=5, depth=18, dtype=torch.float32)


@pytest.mark.parametrize("shape,n", JAX_CASES)
def test_fsdp_spec_equals_the_jax_function_on_its_cases(shape, n):
    assert parallel.fsdp_spec(shape, n) == tuple(jax_fsdp_spec(shape, n))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_spec_equals_the_jax_function_on_every_r18_leaf(r18, n):
    params, stats = to_flax(r18.state_dict())
    shapes = [v.shape for _, v in _leaves(params)] + \
        [v.shape for _, v in _leaves(stats)]
    assert len(shapes) > 100
    for shape in shapes:
        assert parallel.fsdp_spec(shape, n) == tuple(jax_fsdp_spec(shape, n))


@pytest.mark.parametrize("n", [2, 8])
def test_the_cut_dimension_is_the_counterpart_of_the_jax_choice(r18, n):
    dims = parallel.fsdp_dims(r18, n)
    cut = 0
    for name, p in r18.named_parameters():
        full = torch.arange(p.numel(), dtype=torch.float32).reshape(p.shape)
        (_, leaf), = _leaves(to_flax({name: full})[0])
        spec = tuple(jax_fsdp_spec(leaf.shape, n))
        if not spec:
            assert dims[name] is None, name
            continue
        cut += 1
        pieces = np.split(leaf, n, axis=spec.index("data"))
        for i, piece in enumerate(full.chunk(n, dims[name])):
            (_, got), = _leaves(to_flax({name: piece})[0])
            np.testing.assert_array_equal(got, pieces[i], err_msg=name)
    # the conv kernels and the norms' scales and biases that divide
    assert cut > 80
    # RetinaNet's class conv has 45 output channels: its input's are cut
    assert dims["bbox_head.retina_cls.weight"] == 1
    assert dims["backbone.layer1_0.conv1.weight"] == 0


def test_make_mesh_rejects_indivisible():
    with pytest.raises(ValueError):
        parallel.make_mesh(8, space=3)


def _stand_in_mesh(data: int, space: int, coord=(0, 0)):
    """What ``batch_specs`` and ``shard_batch_spatial`` read of a mesh."""
    return types.SimpleNamespace(
        mesh_dim_names=("data", "space"), shape=(data, space),
        get_local_rank=lambda axis: coord[("data", "space").index(axis)])


def _batch(b=8, h=64, w=128, g=8):
    rng = np.random.default_rng(0)
    return {"images": rng.standard_normal((b, h, w, 3), np.float32),
            "gt_boxes": rng.standard_normal((b, g, 4), np.float32),
            "gt_labels": rng.integers(0, 5, (b, g)).astype(np.int32),
            "gt_mask": rng.random((b, g)) < 0.5}


@pytest.mark.parametrize("space", [1, 2])
def test_batch_specs_equal_the_jax_function(space):
    batch = _batch()
    want = jax_batch_specs(batch, jax_make_mesh(8, space=space))
    got = parallel.batch_specs(batch, _stand_in_mesh(8 // space, space))
    assert got == {k: tuple(v) for k, v in want.items()}


def test_shard_batch_spatial_parts_reassemble_the_batch():
    batch = _batch()
    parts = {(d, s): parallel.shard_batch_spatial(
        batch, _stand_in_mesh(4, 2, (d, s))) for d in range(4)
        for s in range(2)}
    images = torch.cat([torch.cat([parts[d, s]["images"] for s in range(2)],
                                  2) for d in range(4)])
    np.testing.assert_array_equal(images.numpy(), batch["images"])
    assert parts[1, 0]["images"].shape == (2, 64, 64, 3)
    for k in ("gt_boxes", "gt_labels", "gt_mask"):
        for d in range(4):
            # whole on each space rank of a data row
            assert torch.equal(parts[d, 0][k], parts[d, 1][k])
        np.testing.assert_array_equal(
            torch.cat([parts[d, 0][k] for d in range(4)]).numpy(), batch[k])
    packed = dict(batch, images=np.zeros((8, 96, 128), np.uint8))
    with pytest.raises(ValueError, match="splits"):
        parallel.shard_batch_spatial(packed, _stand_in_mesh(4, 2))


def _windowed_ops(model) -> dict:
    """The halo of each op ``partition_spatially`` routes through the
    exchange: the backbone's and the neck's convs and max-pools."""
    return {f"{part}.{name}": parallel.window_halo(m)
            for part in ("backbone", "neck")
            for name, m in getattr(model, part).named_modules()
            if isinstance(m, (Conv2d, MaxPool2d))}


def test_window_halos_by_op(r18):
    ops = _windowed_ops(r18)
    want = {"backbone.conv1": (3, 2),             # 7x7 s2 p3
            "backbone.maxpool": (1, 0),           # 3x3 s2 p1, -inf padded
            "backbone.layer1_0.conv1": (1, 1),    # 3x3 s1 p1
            "backbone.layer2_0.conv1": (1, 0),    # 3x3 s2 p1
            "backbone.layer2_0.downsample_conv": (0, 0),  # 1x1 s2
            "neck.lateral_0": (0, 0),             # 1x1
            "neck.fpn_conv_0": (1, 1),
            "neck.extra_conv_0": (1, 0),          # 3x3 s2 p1
            "neck.extra_conv_1": (1, 0)}
    for name, halo in want.items():
        assert ops[name] == halo, name
    # 20 convs in R18's trunk, its max-pool; FPN's 3 laterals, 3 output
    # convs, 2 extras; no norm, no upsample
    assert len(ops) == 21 + 8
    assert not any("bn" in k or "head" in k for k in ops)
    ssd = _windowed_ops(SphSSD(num_classes=3))
    assert ssd["backbone.conv6"] == (6, 6)        # 3x3 dilation 6, p6
    assert ssd["backbone.conv7"] == (0, 0)
    assert ssd["backbone.pool1"] == (0, 0)        # 2x2 s2 ceil
    assert ssd["backbone.pool5"] == (1, 1)        # 3x3 s1 p1
    assert ssd["neck.extra_0_conv"] == (1, 0)
    assert "backbone.l2_norm" not in ssd


SMALL = ["img_size=(64,128)", "bf16=False", "model.backbone.depth=18",
         "data.max_gt=8"]


def test_a_mesh_of_one_changes_nothing(tmp_path):
    cfg = apply_overrides(load_config(
        "configs/sph_rotated_retinanet_r50_fpn_120e_pandora.py"), SMALL)
    family = get_family(cfg)
    rng = np.random.default_rng(1)
    batch = {"images": torch.from_numpy(
        rng.standard_normal((2, 64, 128, 3), np.float32)),
        "gt_boxes": torch.from_numpy(generate_boxes(16, 5, seed=3)
                                     .reshape(2, 8, 5)),
        "gt_labels": torch.zeros(2, 8, dtype=torch.int32),
        "gt_mask": torch.ones(2, 8, dtype=torch.bool)}
    b1 = torch.from_numpy(generate_boxes(61, 4, seed=1))
    b2 = torch.from_numpy(generate_boxes(7, 4, seed=2))

    def stepped(mesh=None):
        model, det_cfg = family.build(cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        optimizer = build_tx(cfg, model, steps_per_epoch=1)
        if mesh is not None:
            assert parallel.partition_spatially(model, mesh) is model
            parallel.shard_state_fsdp(model, optimizer, mesh)
        step = make_generic_train_step(family, model, det_cfg, optimizer)
        metrics = step(batch if mesh is None
                       else parallel.shard_batch_spatial(batch, mesh))
        return model, metrics

    want_model, want = stepped()
    with gloo_world_of_one(tmp_path):
        with pytest.raises(ValueError, match="n_devices=2"):
            parallel.make_mesh(2)
        mesh = parallel.make_mesh()
        assert mesh.mesh_dim_names == ("data", "space")
        assert tuple(mesh.shape) == (1, 1)
        model, got = stepped(mesh)
        iou = parallel.sharded_pairwise_overlaps(b1, b2, mesh)
    assert getattr(model, "space_axis", None) is None
    assert not any(hasattr(p, "fsdp") for p in model.parameters())
    assert all(m.space is None for m in model.modules() if hasattr(m, "space"))
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    for k, v in want_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert torch.equal(iou, sph_overlaps(b1, b2, "sph2pob_efficient",
                                         is_aligned=False))
    assert iou.shape == (61, 7)


def _index_head(family: str, per_cell: int):
    """The real head with every conv and norm an identity: fed a level's
    grid of flat indices, it returns them in its own output order."""
    if family == "retina":
        head = SphRetinaHead(num_classes=1, box_version=1,
                             num_base_priors=per_cell, stacked_convs=1)
        names = ("cls_conv_0", "reg_conv_0", "retina_cls", "retina_reg")
    else:
        head = SphFCOSHead(num_classes=1, stacked_convs=1)
        names = ("cls_conv_0", "cls_gn_0", "reg_conv_0", "reg_gn_0",
                 "conv_cls", "conv_reg", "conv_centerness")
    for name in names:
        setattr(head, name, nn.Identity())
    return head


@pytest.mark.parametrize("img_size", [(512, 1024), (64, 128)])
@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("family", ["retina", "fcos"])
def test_head_part_owns_each_anchor_once_in_the_heads_order(family, space,
                                                            img_size):
    if family == "retina":
        cfg = retina_config(3, box_version=5, img_size=img_size)
        per_cell = cfg.anchor_generator.num_base_anchors
        centres = cfg.flat_anchors()[:, 0] / 360.0            # of the width
    else:
        cfg = fcos_config(3, img_size=img_size)
        per_cell = 1
        centres = torch.cat(cfg.level_points()[0])[:, 0] / img_size[1]
    sizes = cfg.featmap_sizes()
    total = per_cell * sum(h * w for h, w in sizes)
    assert centres.shape == (total,)
    head = _index_head(family, per_cell)
    grids, off = [], 0
    for h, w in sizes:
        grids.append(off + torch.arange(h * w * per_cell, dtype=torch.float32)
                     .reshape(1, h, w, per_cell).permute(0, 3, 1, 2))
        off += h * w * per_cell
    parts = [parallel.head_part(sizes, per_cell, space, r)
             for r in range(space)]
    seen = torch.cat([p.indices for p in parts])
    assert torch.equal(seen.sort().values, torch.arange(total))
    for r, part in enumerate(parts):
        # a split level's columns, or a narrow one whole on rank 0 alone
        local = [g[..., r * (g.shape[-1] // space):
                   (r + 1) * (g.shape[-1] // space)]
                 if g.shape[-1] % space == 0 else g for g in grids]
        kept = part.keep(head(local)[0])
        got = torch.cat([y.reshape(-1) for y in kept]).long()
        assert torch.equal(got, part.indices)
        narrow = [w % space != 0 for _, w in sizes]
        assert part.levels == tuple(r == 0 or not n for n in narrow)
        split = torch.cat([torch.full((h * w * per_cell,), w % space == 0)
                           for h, w in sizes])[part.indices]
        c = centres[part.indices][split]
        # centres on a column's left edge, in float32 degrees
        assert bool(((c >= r / space - 1e-6) & (c < (r + 1) / space)).all())
    if img_size == (512, 1024):
        # every level splits: each rank an equal share (K1's input width)
        assert all(len(p.indices) == total // space for p in parts)


@pytest.mark.parametrize("k", [3, 8])
def test_positive_gather_keeps_the_rows_jax_top_k_keeps(k):
    """Of equal weights the lower rows, as ``jax.lax.top_k`` keeps them: the
    rule by which the ranks of a split head keep one process's rows."""
    w = np.array([0, 1, 1, 0, 2, 1, 1, 0, 1, 2, 0, 1], np.float32)
    idx, got = _pos_gather(torch.from_numpy(w), k)
    want, want_idx = jax.lax.top_k(jax.numpy.asarray(w), k)
    assert idx.tolist() == np.asarray(want_idx).tolist()
    assert got.tolist() == np.asarray(want).tolist()

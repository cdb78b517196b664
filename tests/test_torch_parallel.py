"""The port's data parallelism in one process, on the CPU (no subprocess).

- The sharded ``DataLoader`` against the JAX package's at the cases of its
  own tests (``tests/test_distributed.py``): the ``img_id`` lists equal as
  integers, the images within 1e-6 (they are equal).
- ``init_distributed`` refuses an unknown launcher and a missing torchrun
  variable by name.
- In a gloo group of one process (``file://`` store, removed after):
  ``sync_global_value``, ``all_gather_eval_arrays``, ``coordination_barrier``,
  ``global_count``, ``global_metrics`` and the gradient all-reduce are
  identities, bit for bit.
- ``evaluate_dataset(distributed=True)`` equals ``distributed=False``
  exactly in a group of one, and the JAX package's ``evaluate_dataset`` on
  the same predictions and IoUs exactly (the existing evaluation test's
  tolerance: metrics equal); the shards' gathered results, de-duplicated,
  equal the whole split's.

The gathers of several ranks are the job of ``test_torch_parallel_ranks.py``.
"""

import json
import types

import numpy as np
import pytest
import torch

from sph_retina_tpu.data import DataLoader as JaxDataLoader
from sph_retina_tpu.data import SphPipeline as JaxPipeline
from sph_retina_tpu.data import make_synthetic_dataset as jax_synthetic
from sph_retina_tpu.engine import builder as jbuilder
from sph_retina_tpu.engine import eval as jeval
from sph_retina_tpu.engine import evaluator as jevaluator
from sph_retina_tpu_torch import parallel
from sph_retina_tpu_torch.boxes.nms import NMSResult
from sph_retina_tpu_torch.data import (
    DataLoader,
    SphPipeline,
    make_synthetic_dataset,
)
from sph_retina_tpu_torch.engine import builder as tbuilder
from sph_retina_tpu_torch.engine import evaluator as tevaluator
from sph_retina_tpu_torch.engine.zoo import get_family

from test_torch_eval import _cfg, _port_iou
from utils.process_group import gloo_world_of_one
from utils.synthetic_coco import write_synthetic_coco

IMG = (16, 32)


def _loaders(n_images, batch, num_shards, shard_id, shuffle=True,
             drop_last=True, aug_seed=None, training=False):
    """The port's and the JAX package's loader, set up alike
    (``tests/test_distributed.py:_loader``)."""
    kw = dict(n_images=n_images, num_classes=3, img_size=IMG)
    pipe = dict(img_size=IMG, max_gt=4, training=training)
    args = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last,
                num_shards=num_shards, shard_id=shard_id, num_workers=1,
                seed=7, aug_seed=aug_seed)
    return (DataLoader(make_synthetic_dataset(**kw), SphPipeline(**pipe),
                       **args),
            JaxDataLoader(jax_synthetic(**kw), JaxPipeline(**pipe), **args))


def _epoch(loader, epoch):
    return list(loader.epoch(epoch))


# (n_images, batch, shards, shuffle, drop_last, epochs, aug_seed of rank r)
LOADER_CASES = {
    "12_over_2": (12, 2, 2, True, True, (0,), None),
    "10_over_3_uneven": (10, 2, 3, False, False, (0,), None),
    "16_over_2_epochs": (16, 2, 2, True, True, (0, 1, 5), None),
    "diff_seed": (16, 2, 2, True, True, (0, 1), lambda r: 7 + r),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_sharded_loader_equals_the_jax_packages(case):
    n, batch, shards, shuffle, drop_last, epochs, aug = LOADER_CASES[case]
    ids = {}
    for rank in range(shards):
        tl, jl = _loaders(n, batch, shards, rank, shuffle, drop_last,
                          aug_seed=aug(rank) if aug else None,
                          training=aug is not None)
        assert len(tl) == len(jl)
        for epoch in epochs:
            got, want = _epoch(tl, epoch), _epoch(jl, epoch)
            assert len(got) == len(want) == len(tl)
            got_ids = [int(i) for b in got for i in b["img_id"]]
            assert got_ids == [int(i) for b in want for i in b["img_id"]]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g["images"], w["images"],
                                           atol=1e-6, rtol=0)
                np.testing.assert_array_equal(g["gt_boxes"], w["gt_boxes"])
            ids[rank, epoch] = got_ids
    for epoch in epochs:
        union = [i for r in range(shards) for i in ids[r, epoch]]
        assert len({len(ids[r, epoch]) for r in range(shards)}) == 1
        if drop_last and n % (shards * batch) == 0:
            assert sorted(union) == list(range(n))  # a partition
        else:
            assert set(union) == set(range(n))  # wrap-padded cover
    if aug is not None:
        # the ranks' augmentation streams differ, their shuffle does not:
        # an image of rank 0 seen with rank 1's stream flips otherwise
        t0 = _loaders(n, batch, shards, 0, aug_seed=7, training=True)[0]
        t1 = _loaders(n, batch, shards, 0, aug_seed=8, training=True)[0]
        a, b = _epoch(t0, 0), _epoch(t1, 0)
        assert [x["img_id"].tolist() for x in a] == \
            [x["img_id"].tolist() for x in b]
        assert any(not np.array_equal(x["images"], y["images"])
                   for x, y in zip(a, b))


def test_init_distributed_refuses_by_name(monkeypatch):
    assert not torch.distributed.is_initialized()
    assert parallel.init_distributed("none") == (0, 1)
    with pytest.raises(ValueError, match="unknown launcher 'slurm'"):
        parallel.init_distributed("slurm")
    for var in parallel.distributed.TORCHRUN_VARIABLES:
        monkeypatch.setenv(var, "0")
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="missing: MASTER_PORT$"):
        parallel.init_distributed("torch", device="cpu")
    assert not torch.distributed.is_initialized()


def test_world_of_one_collectives_are_identities(tmp_path):
    arrays = {"boxes": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              "img_id": np.array([4, 1])}
    model = torch.nn.Linear(3, 2)
    model(torch.ones(5, 3)).square().sum().backward()
    grads = [p.grad.clone() for p in model.parameters()]
    before = [p.detach().clone() for p in model.parameters()]
    count = torch.tensor(7)
    metrics = {"loss": torch.tensor(1.5), "loss_cls": torch.tensor(0.25)}
    with gloo_world_of_one(tmp_path):
        assert parallel.init_distributed("torch") == (0, 1)  # taken as is
        assert (parallel.get_rank(), parallel.get_world_size()) == (0, 1)
        assert parallel.sync_global_value({"seed": 3}) == {"seed": 3}
        got = parallel.all_gather_eval_arrays(arrays)
        parallel.coordination_barrier("test", timeout_s=10)
        assert parallel.global_count(count) is count
        assert parallel.global_metrics(metrics) is metrics
        parallel.all_reduce_gradients(list(model.parameters()),
                                      bucket_bytes=16)  # two buckets
        parallel.broadcast_parameters(model)
    assert got.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(got[k], arrays[k])
    for p, g, b in zip(model.parameters(), grads, before):
        assert torch.equal(p.grad, g) and torch.equal(p.detach(), b)
    assert parallel.host_local_copy({"a": [torch.ones(2)]})["a"][0].device \
        == torch.device("cpu")


def test_gradient_buckets_keep_dtype_and_order():
    """Consecutive runs of one dtype, at most ``bucket_bytes`` each (a
    larger tensor alone), in the parameters' order."""
    tensors = [torch.zeros(3), torch.zeros(5),
               torch.zeros(2, dtype=torch.float64), torch.zeros(40),
               torch.zeros(1)]
    runs = list(parallel.distributed._buckets(tensors, bucket_bytes=40))
    assert [[t.numel() for t in r] for r in runs] == [[3, 5], [2], [40],
                                                      [1]]
    assert [t for r in runs for t in r] == tensors


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """A COCO-style set of 9 images (odd, so that two shards wrap-pad)."""
    root = tmp_path_factory.mktemp("coco")
    ann, img_dir = write_synthetic_coco(str(root), n_images=9, num_classes=3,
                                        img_size=(64, 128))
    with open(ann) as f:
        assert len(json.load(f)["images"]) == 9
    return _cfg(ann, img_dir + "/")


def _scores(images) -> np.ndarray:
    """Per image a score from its pixels, in float64 on the host, so that
    both packages' stand-ins rank detections alike without ties."""
    m = np.asarray(images, np.float64).reshape(len(images), -1).mean(1)
    return 0.3 + 0.6 * (m - np.floor(m))


K = 3
_G = np.arange(K, dtype=np.float32)
BOXES = np.stack([60 + 90 * _G, 80 + 10 * _G, 40 + 0 * _G, 30 + 0 * _G,
                  0 * _G], -1)


def _port_predict(images):
    b = images.shape[0]
    s = torch.from_numpy(_scores(images.cpu().numpy()).astype(np.float32))
    return NMSResult(torch.from_numpy(BOXES).expand(b, K, 5),
                     s[:, None] * torch.tensor([1.0, 0.8, 0.6]),
                     torch.zeros((b, K), dtype=torch.int32),
                     torch.arange(K).expand(b, K),
                     torch.ones((b, K), dtype=torch.bool))


def _jax_predict(variables, images):
    b = images.shape[0]
    s = _scores(np.asarray(images)).astype(np.float32)
    return types.SimpleNamespace(
        boxes=np.broadcast_to(BOXES, (b, K, 5)),
        scores=s[:, None] * np.array([1.0, 0.8, 0.6], np.float32),
        labels=np.zeros((b, K), np.int32), valid=np.ones((b, K), bool))


THRS = (0.05, 0.1, 0.5)


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gathered_evaluation_equals_ungathered_and_the_jax_packages(
        val_set, tmp_path, monkeypatch):
    det_cfg = get_family(val_set).build(val_set)[1]
    ds, loader = tbuilder.build_datasets(val_set, "val")

    def run(distributed, loader=loader, raw=False):
        return tevaluator.evaluate_dataset(
            torch.nn.Linear(1, 1), det_cfg, loader, predict=_port_predict,
            iou_thrs=THRS, distributed=distributed, return_raw=raw)

    want = run(False)
    with gloo_world_of_one(tmp_path):
        got = run(True)
    _same(got, want)
    assert got["n_images"] == len(ds) == 9
    assert want["mAP"] > 0  # the stand-in's boxes hit some gts

    # the JAX package on the same predictions, with the port's IoUs
    monkeypatch.setattr(jeval, "_pairwise_iou_np", _port_iou)
    jds, jloader = jbuilder.build_datasets(val_set, "val")
    jwant = jevaluator.evaluate_dataset(
        None, det_cfg, None, jloader, iou_thrs=THRS, predict=_jax_predict,
        distributed=True)
    for k in ("mAP", "AP50", "AP75", "n_images"):
        assert got[k] == jwant[k], k
    np.testing.assert_array_equal(got["per_class"], jwant["per_class"])

    # two shards: each rank's padded arrays, gathered in rank order and
    # de-duplicated, score as the whole split
    shard = [tbuilder.build_datasets(val_set, "val", 2, r)[1]
             for r in range(2)]
    _, rank1 = run(False, shard[1], raw=True)
    assert rank1["img_id"].shape[0] == 5  # 9 over 2: one image twice
    monkeypatch.setattr(
        tevaluator, "all_gather_eval_arrays",
        lambda local: {k: np.concatenate([local[k], rank1[k]])
                       for k in local})
    gathered = run(True, shard[0])
    _same(gathered, want)

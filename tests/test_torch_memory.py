"""The port's device-OOM retry ladder (``utils/memory.py``) against the JAX
package's semantics (``tests/test_memory_and_download.py``), with PyTorch's
error types, and the evaluation's matcher under it, on the CPU."""

import numpy as np
import pytest
import torch

from sph_retina_tpu_torch.engine import eval as teval
from sph_retina_tpu_torch.utils import memory
from sph_retina_tpu_torch.utils.memory import AvoidOOM, is_oom_error


def fake_oom():
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 12.00 MiB")


@pytest.mark.parametrize("err, oom", [
    (fake_oom(), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (ValueError("shape mismatch"), False),
    (ValueError("CUDA out of memory"), False),  # not a RuntimeError
])
def test_is_oom_error_classification(err, oom):
    assert is_oom_error(err) is oom


def test_retry_passes_through_success_and_other_errors():
    calls = []

    @AvoidOOM(verbose=False)
    def ok(x):
        calls.append(1)
        return x + 1

    assert float(ok(torch.tensor(1.0))) == 2.0
    assert len(calls) == 1

    @AvoidOOM(verbose=False)
    def boom(x):
        raise ValueError("not an oom")

    with pytest.raises(ValueError):
        boom(torch.zeros(2))


def test_retry_ladder_retries_after_gc_at_full_precision(monkeypatch):
    freed = []
    monkeypatch.setattr(memory.gc, "collect", lambda: freed.append(1))
    seen = []

    @AvoidOOM(verbose=False)
    def fn(x):
        seen.append(x.dtype)
        if len(seen) == 1:
            raise fake_oom()
        return x * 2

    out = fn(torch.ones(4))
    assert seen == [torch.float32, torch.float32] and freed == [1]
    assert out.dtype == torch.float32 and torch.equal(out, torch.full((4,), 2.0))


def test_retry_ladder_falls_back_to_bf16():
    seen = []

    @AvoidOOM(verbose=False)
    def fn(x, scale):
        seen.append(x.dtype)
        if x.dtype != torch.bfloat16:
            raise fake_oom()
        return {"y": x * 2, "n": torch.tensor([3])}

    with pytest.warns(UserWarning, match="bfloat16"):
        out = fn(torch.ones(4, dtype=torch.float32), scale=2)
    # the full-precision try, the gc retry, then the bf16 rung succeeds
    assert seen == [torch.float32, torch.float32, torch.bfloat16]
    # float outputs are cast back to fp32 for the caller; others kept
    assert out["y"].dtype == torch.float32 and out["n"].dtype == torch.int64
    np.testing.assert_allclose(out["y"].numpy(), 2.0)


def test_retry_ladder_falls_back_to_the_cpu(monkeypatch):
    devices = []
    moved = []
    real = memory._to_cpu
    monkeypatch.setattr(memory, "_to_cpu",
                        lambda tree: moved.append(1) or real(tree))

    @AvoidOOM(to_bf16=False, verbose=False)
    def fn(x):
        devices.append(x.device.type)
        if len(devices) < 3:
            raise fake_oom()  # the first try and the gc retry
        return x + 1

    with pytest.warns(UserWarning, match="CPU"):
        out = fn(torch.zeros(3))
    np.testing.assert_allclose(out.numpy(), 1.0)
    assert devices == ["cpu"] * 3 and moved == [1, 1]  # args and kwargs


def test_retry_ladder_exhausted():
    def always():
        raise fake_oom()

    with pytest.raises(RuntimeError, match="retry ladder") as info:
        AvoidOOM(to_bf16=False, to_cpu=False, verbose=False)(always)()
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)


def test_the_matchers_iou_climbs_the_ladder(monkeypatch):
    """``_pairwise_iou_np`` goes through ``AvoidOOM``: an OOM on the first
    call is retried, and the matrix is bitwise the unwrapped one."""
    rng = np.random.default_rng(0)
    dets = np.stack([rng.uniform(20, 340, 6), rng.uniform(40, 140, 6),
                     rng.uniform(15, 60, 6), rng.uniform(15, 60, 6),
                     rng.uniform(-40, 40, 6)], 1).astype(np.float32)
    gts = dets[:4] + rng.normal(0, 2, (4, 5)).astype(np.float32)
    want = teval._pairwise_iou_np(dets, gts, "sph2pob_efficient",
                                  device="cpu")
    real, calls = teval.sph_overlaps, []

    def flaky(a, b, backend):
        calls.append(a.dtype)
        if len(calls) == 1:
            raise fake_oom()
        return real(a, b, backend)

    monkeypatch.setattr(teval, "sph_overlaps", flaky)
    got = teval._pairwise_iou_np(dets, gts, "sph2pob_efficient",
                                 device="cpu")
    assert calls == [torch.float32, torch.float32]
    np.testing.assert_array_equal(got, want)
    assert want.shape == (6, 4) and want.max() > 0.5

"""Device-OOM retry ladder (the reference's ``AvoidCUDAOOM``).

The JAX package's ladder, on PyTorch's CUDA allocator:

1. drop dead Python references (``gc.collect()``) and return the caching
   allocator's free blocks (``torch.cuda.empty_cache()``), then retry;
2. retry with floating-point tensors cast to **bfloat16**, casting float
   outputs to fp32;
3. retry on the **CPU** with the original tensors moved there.

Only out-of-memory failures climb the ladder: ``torch.cuda.OutOfMemoryError``
and a ``RuntimeError`` saying "CUDA out of memory". Each rung synchronises
the card before it returns, so an out-of-memory error raised by a kernel
that runs after the call has returned is caught by the rung that launched
it, not at the caller's first use of the result.
"""

from __future__ import annotations

import functools
import gc
import warnings

import torch

__all__ = ["is_oom_error", "AvoidOOM"]


def is_oom_error(err: BaseException) -> bool:
    """True if ``err`` is a CUDA out-of-memory failure."""
    return isinstance(err, torch.cuda.OutOfMemoryError) or (
        isinstance(err, RuntimeError) and "CUDA out of memory" in str(err))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _cast_floats(tree, dtype):
    return _tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                     and x.is_floating_point() else x, tree)


def _to_cpu(tree):
    return _tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                     else x, tree)


def _synchronized(out):
    """``out`` once the card has finished the work that makes it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


class AvoidOOM:
    """Decorator/wrapper that retries a tensor op when the card runs out of
    memory.

    >>> iou = AvoidOOM()(compute_pairwise_iou)   # doctest: +SKIP
    >>> iou = AvoidOOM(to_cpu=False)(fn)         # no CPU fallback

    Args:
        to_bf16: enable the bfloat16 retry rung (default True).
        to_cpu: enable the CPU retry rung (default True).
        verbose: kept for API compatibility. Result-altering fallbacks
            (bf16, CPU) always warn, so that a precision change is never
            silent.
    """

    def __init__(self, to_bf16: bool = True, to_cpu: bool = True,
                 verbose: bool = True):
        self.to_bf16 = to_bf16
        self.to_cpu = to_cpu
        self.verbose = verbose

    def _warn(self, msg: str) -> None:
        warnings.warn(msg, stacklevel=3)

    def __call__(self, func):
        name = getattr(func, "__name__", func)

        @functools.wraps(func)
        def wrapped(*args, **kwargs):
            try:
                return _synchronized(func(*args, **kwargs))
            except Exception as err:  # noqa: BLE001 — filtered below
                if not is_oom_error(err):
                    raise
            # rung 1: free dead blocks and retry at full precision
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            try:
                return _synchronized(func(*args, **kwargs))
            except Exception as err:  # noqa: BLE001 — filtered below
                if not is_oom_error(err):
                    raise
                last_oom = err

            # rung 2: bfloat16 inputs, float outputs cast to fp32
            if self.to_bf16:
                self._warn(f"{name}: device OOM; retrying with bfloat16 "
                           "inputs")
                try:
                    out = func(*_cast_floats(args, torch.bfloat16),
                               **_cast_floats(kwargs, torch.bfloat16))
                    return _cast_floats(_synchronized(out), torch.float32)
                except Exception as err:  # noqa: BLE001 — filtered below
                    if not is_oom_error(err):
                        raise
                    last_oom = err

            # rung 3: the CPU at full precision
            if self.to_cpu:
                self._warn(f"{name}: device OOM; falling back to the CPU")
                return func(*_to_cpu(args), **_to_cpu(kwargs))

            raise RuntimeError(
                f"{name} exhausted the OOM retry ladder (remaining rungs "
                "disabled or unavailable)") from last_oom

        return wrapped

"""A process group of one process for the tests: gloo over a ``file://``
store, torn down and its store removed however the test ends."""

import contextlib
import datetime
import os

import torch.distributed as dist


@contextlib.contextmanager
def gloo_world_of_one(directory, timeout_s: float = 60.0):
    store = os.path.join(str(directory), "gloo_store")
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)

"""Run a function on a ring of gloo ranks, one CPU process each, for the
port's multi-rank tests (tests/test_torch_{halo_async,sharded_am,...}.py).

Each rank initialises the default process group from a ``file://`` store
under the test's tmp_path with a 60 s timeout and one torch thread (the
suite already runs several workers), unless the caller asks it to join
the group itself (``group=False``); the parent joins with a timeout and
kills every child that is still alive when it stops waiting, so a hang
fails its test instead of the whole run. ``fn(rank, world, *args)`` must
be a module-level function of a module that imports no jax: the children
import only torch.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, world: int, store: str, fn, args, group: bool):
    torch.set_num_threads(1)
    if group:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=60))
    try:
        fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(tmp_path, world: int, fn, *args, timeout: float = 120.0, group: bool = True):
    """Run ``fn`` on ``world`` spawned gloo ranks; raise if one fails or
    they are not done within ``timeout`` seconds. With ``group=False`` the
    ranks start with no process group: ``fn`` joins one itself."""
    ctx = mp.start_processes(_rank, args=(world, str(tmp_path / "store"), fn,
                                          args, group),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks not done in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()

"""A pool of gloo ranks for the port's mesh tests (not a test file).

`RankPool(n)` spawns n processes once (a module-scoped fixture of each
tests/test_torch_mesh*.py file). `run(world, fn, *args)` has ranks
0..world-1 call `fn(*args)` inside a gloo process group of `world` ranks
(built anew when the size changes, met through a new file in the pool's
own temporary directory, so no TCP port is raced for; the other ranks
wait) and returns their results in rank order. `fn` is a module-level
function, which a spawned process imports by name. Every worker caps
torch at one thread.
"""
from __future__ import annotations

import datetime
import itertools
import multiprocessing as mp
import os
import shutil
import tempfile
import traceback

TIMEOUT_S = 300.0
# a collective that waits longer raises, so a rank that failed cannot hang
# the others past it
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def _worker(rank: int, tasks, results) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    world = None
    while True:
        task = tasks.get()
        if task is None:
            break
        size, store, fn, args = task
        if rank >= size:
            continue
        try:
            if world != store:
                if dist.is_initialized():
                    dist.destroy_process_group()
                dist.init_process_group(
                    "gloo", init_method=f"file://{store}", rank=rank,
                    world_size=size, timeout=COLLECTIVE_TIMEOUT)
                world = store
            results.put((rank, True, fn(*args)))
        except BaseException:  # noqa: BLE001 — sent back, raised there
            results.put((rank, False, traceback.format_exc()))
    if dist.is_initialized():
        dist.destroy_process_group()


class RankPool:
    def __init__(self, n: int):
        ctx = mp.get_context("spawn")
        self.n = n
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        env = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        try:
            self._procs = [ctx.Process(target=_worker,
                                       args=(r, self._tasks[r],
                                             self._results), daemon=True)
                           for r in range(n)]
            for p in self._procs:
                p.start()
        finally:
            if env is None:
                os.environ.pop("OMP_NUM_THREADS")
            else:
                os.environ["OMP_NUM_THREADS"] = env
        self._world = None
        self._broken = None
        self._dir = tempfile.mkdtemp(prefix="mesh_pool_")
        self._stores = itertools.count()

    def run(self, world: int, fn, *args) -> list:
        """[fn(*args) on rank r for r < world]; raises with the first
        failing rank's traceback, after which the pool runs nothing."""
        if self._broken:
            raise RuntimeError(f"the pool broke earlier:\n{self._broken}")
        if world > self.n:
            raise ValueError(f"a world of {world} on a pool of {self.n}")
        if self._world is None or self._world[0] != world:
            store = os.path.join(self._dir, f"store{next(self._stores)}")
            self._world = (world, store)
        for q in self._tasks:
            q.put((world, self._world[1], fn, args))
        out = {}
        for _ in range(world):
            rank, ok, value = self._results.get(timeout=TIMEOUT_S)
            if not ok:
                self._broken = f"rank {rank} failed:\n{value}"
                raise RuntimeError(self._broken)
            out[rank] = value
        return [out[r] for r in range(world)]

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self._dir, ignore_errors=True)

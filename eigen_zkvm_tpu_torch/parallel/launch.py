"""Start the ranks of a sharded prove: under torchrun, or spawned here.

    torchrun --nproc-per-node 4 my_prove.py     # init_from_env() in it
    python -m eigen_zkvm_tpu_torch.bench_sharded   # RankPool inside

`init_from_env` joins the process group that torchrun describes (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and returns the rank's
`Mesh`.  `RankPool` spawns `world` ranks on this host that stay up between
calls: `pool.run(fn, *args)` runs `fn(mesh, *args)` on every rank and
returns the results in rank order.  The ranks start with the `spawn`
method (CUDA is never carried across a fork) and run `_worker`, which
lives in this module so that a spawned process can import it; `fn` must be
importable too (a module-level function).  They join through a `file://`
store in a temporary directory, and bind gloo and NCCL's bootstrap to the
loopback interface unless the environment names another.

Backends: "nccl" puts each rank on its own card (`LOCAL_RANK`), "gloo"
lets ranks share a card or run on the CPU (`device="cpu"`).  Ranks run on
CUDA devices unless the caller passes device="cpu"; without a card they
raise.  A failed init raises: no backend stands in for another.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

from .meshctx import Mesh, rank_device

TIMEOUT_S = 600   # a collective, or a pool's task, that waits longer fails


class RankError(RuntimeError):
    """A rank failed: its traceback, or a pool that stopped answering."""


def init_from_env(backend: str = "nccl", device=None,
                  data: int = 1) -> Mesh:
    """Join torchrun's process group and return this rank's Mesh on a
    (data, world / data) grid; the rank's device is `device` or card
    LOCAL_RANK."""
    dev = rank_device(backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Mesh(data, dev)


def _worker(rank: int, world: int, store: str, backend: str, device,
            threads, tasks, results):
    """A spawned rank: join the group, then run tasks until None."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    meshes: dict = {}
    try:
        dev = rank_device(backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        results.put((rank, True, None))
    except Exception:   # reported to the parent, which stops the pool
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while (task := tasks.get()) is not None:
            fn, args, data = task
            try:
                if data not in meshes:   # collective: every rank makes it
                    meshes[data] = Mesh(data, dev)
                results.put((rank, True, fn(meshes[data], *args)))
            except Exception:   # reported to the parent, which stops the pool
                results.put((rank, False, traceback.format_exc()))
                return
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` spawned ranks of one process group on this host.

    `device` None puts rank r on card r mod the host's cards (raising
    without one); "cpu" keeps every rank on the CPU (gloo only).  `threads`
    sets each rank's torch threads.  A rank that raises, or a pool that
    does not answer within TIMEOUT_S, stops every rank and raises
    RankError; the pool is then closed.  Use as a context manager or
    call close()."""

    def __init__(self, world: int, backend: str = "gloo", device=None,
                 threads: int | None = None):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self._dir = tempfile.mkdtemp(prefix="rankpool-")
        store = os.path.join(self._dir, "store")
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(r, world, store, backend, device, threads,
                  self._tasks[r], self._results)) for r in range(world)]
        for p in self._procs:
            p.start()
        self._collect()

    def _collect(self) -> list:
        out = [None] * self.world
        for _ in range(self.world):
            try:
                rank, ok, value = self._results.get(timeout=TIMEOUT_S)
            except queue.Empty:
                self.close(force=True)
                raise RankError(f"no answer from the ranks within "
                                f"{TIMEOUT_S} s") from None
            if not ok:
                self.close(force=True)
                raise RankError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        return out

    def run(self, fn, *args, data: int = 1) -> list:
        """fn(mesh, *args) on every rank, the mesh a (data, world / data)
        grid; the results in rank order."""
        if not self._procs:
            raise RankError("the pool is closed")
        for q in self._tasks:
            q.put((fn, args, data))
        return self._collect()

    def close(self, force: bool = False):
        """Stop the ranks and remove the store: each rank leaves after its
        task, or is terminated when it does not within 30 s (at once with
        `force`: a pool whose rank failed has ranks waiting in a
        collective)."""
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=0 if force else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def spawn(world: int, fn, *args, backend: str = "gloo", device=None,
          threads: int | None = None) -> list:
    """fn(mesh, *args) on `world` ranks spawned for this one call (a
    (1, world) grid); the results in rank order."""
    with RankPool(world, backend, device, threads) as pool:
        return pool.run(fn, *args)

"""Ranks on a (data, model) grid over torch.distributed, and the layout
changes of the sharded prover as explicit collectives.

Port of eigen_zkvm_tpu/parallel/meshctx.py (`active`, `activate`,
`_constrain`, `rows`, `cols`, `replicated`).  Where the JAX package marks a
stage's layout and lets XLA's partitioner insert the collectives, here each
layout change is a call on the `Mesh` that the prover holds (through
`stark/engine.py::Engine`, never a process-wide global):

  rows_to_cols   row blocks -> column blocks: one all_to_all (the LDE's
                 input, pol-sharded so its butterflies stay local)
  cols_to_rows   column blocks -> row blocks: one all_to_all (Merkle
                 leaves and the VM's columns)
  replicated     row blocks -> the whole array on every rank: all_gather
  rows           the whole array -> this rank's row block: a slice
  roll           a next-row rotation: the next (or previous) rank's first
                 (or last) k rows come in as a halo, cyclically
  row_sum        sums over rows: all_reduce

A width the model axis does not divide stays replicated, as JAX's
`_constrain` leaves it.  Rank r of the world sits at (r // model,
r % model); the model axis of its data row is its group.

The backend is the caller's choice.  With NCCL each rank has its own card
and the collectives run on device tensors.  With gloo ranks share a card
or run on the CPU, and every collective stages its tensors through host
buffers (a CPU tensor is its own host buffer): one code path, whatever the
device.  `stats` counts each kind of collective's calls, seconds (host
clock around the call, the staging copies and a device drain included)
and the bytes this rank handed in.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist


def local_rank() -> int:
    """This process's index on its host (torchrun's LOCAL_RANK, else its
    global rank)."""
    env = os.environ.get("LOCAL_RANK")
    return dist.get_rank() if env is None else int(env)


def rank_device(backend: str, device=None) -> torch.device:
    """The device of this rank: `device` when given, else the card
    LOCAL_RANK mod the cards on the host.  NCCL wants a card of its own
    for every rank; gloo ranks may share one.  Raises without a card
    unless `device` is "cpu"."""
    if device is not None:
        device = torch.device(device)
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    else:
        device = torch.device("cuda",
                              local_rank() % torch.cuda.device_count())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device a rank")
    return device


class Mesh:
    """This rank's place on a (data, model) grid of the initialised
    default process group, its device, and the model axis' collectives.

    Every rank constructs its Mesh with the same `data` (the process
    groups of the data rows are made collectively).  `model` =
    world / data must be a power of two."""

    def __init__(self, data: int = 1, device=None):
        world, rank = dist.get_world_size(), dist.get_rank()
        if data < 1 or world % data:
            raise ValueError(f"a data axis of {data} does not divide "
                             f"{world} ranks")
        model = world // data
        if model & (model - 1):
            raise ValueError(f"the model axis ({model}) must be a power "
                             "of two")
        self.backend = dist.get_backend()
        self.device = rank_device(self.backend, device)
        self.data, self.model = data, model
        self.rank = rank
        self.coords = divmod(rank, model)   # (data index, model index)
        self.ranks = [self.coords[0] * model + j for j in range(model)]
        groups = [dist.new_group([d * model + j for j in range(model)])
                  for d in range(data)] if data > 1 else [None]
        self.group = groups[self.coords[0]]
        self.stats: dict[str, list] = {}   # kind -> [calls, seconds, bytes]

    def __repr__(self):
        return (f"Mesh(data={self.data}, model={self.model}, rank="
                f"{self.rank}, coords={self.coords}, device={self.device}, "
                f"backend={self.backend})")

    # ---- the collectives of the model axis

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The buffer a collective gets: host memory under gloo."""
        t = t.contiguous()
        return t.cpu() if self.backend == "gloo" else t

    def _count(self, kind: str, t0: float, nbytes: int):
        if self.backend != "gloo" and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        s = self.stats.setdefault(kind, [0, 0.0, 0])
        s[0] += 1
        s[1] += time.perf_counter() - t0
        s[2] += nbytes

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[model, *t.shape]: every rank's t, in model order."""
        t0 = time.perf_counter()
        src = self._stage(t)
        out = [torch.empty_like(src) for _ in range(self.model)]
        dist.all_gather(out, src, group=self.group)
        res = torch.stack(out).to(self.device)
        self._count("all_gather", t0, src.numel() * src.element_size())
        return res

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t [model, ...]: chunk j goes to model rank j; chunk j of the
        result came from model rank j."""
        if t.shape[0] != self.model:
            raise ValueError(f"all_to_all takes [{self.model}, ...], got "
                             f"{tuple(t.shape)}")
        t0 = time.perf_counter()
        src = self._stage(t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        res = out.to(self.device)
        self._count("all_to_all", t0, src.numel() * src.element_size())
        return res

    def row_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's t (int64 sums wrap)."""
        t0 = time.perf_counter()
        src = self._stage(t)
        if src is t:
            src = src.clone()
        dist.all_reduce(src, group=self.group)
        res = src.to(self.device)
        self._count("all_reduce", t0, src.numel() * src.element_size())
        return res

    def from_owner(self, t: torch.Tensor, owner: int) -> torch.Tensor:
        """Model rank `owner`'s t on every rank (t has the same shape and
        dtype on all)."""
        t0 = time.perf_counter()
        src = self._stage(t)
        if src is t:
            src = src.clone()
        dist.broadcast(src, self.ranks[owner], group=self.group)
        res = src.to(self.device)
        self._count("broadcast", t0, src.numel() * src.element_size())
        return res

    # ---- row layout: an array of n rows is sharded when the axis divides n

    def sharded(self, n: int) -> bool:
        """Whether n rows split into the model axis' row blocks."""
        return self.model > 1 and n % self.model == 0

    def block(self, n: int) -> tuple[int, int]:
        """(first row, rows) of this rank's block of n rows."""
        if not self.sharded(n):
            return 0, n
        size = n // self.model
        return self.coords[1] * size, size

    def rows(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's row block of a replicated array (no communication);
        an array the axis does not divide stays whole."""
        r0, size = self.block(full.shape[0])
        return full if size == full.shape[0] else full[r0 : r0 + size]

    def replicated(self, block: torch.Tensor) -> torch.Tensor:
        """The whole array from its row blocks: one all_gather."""
        if self.model == 1:
            return block
        g = self.all_gather(block)
        return g.reshape(-1, *block.shape[1:])

    def rows_to_cols(self, block: torch.Tensor) -> torch.Tensor:
        """[n / model, w] row blocks -> [n, w / model] column blocks (w a
        multiple of model): one all_to_all."""
        m = self.model
        R, w = block.shape
        chunks = block.reshape(R, m, w // m).transpose(0, 1)
        return self.all_to_all(chunks).reshape(m * R, w // m)

    def cols_to_rows(self, cols: torch.Tensor) -> torch.Tensor:
        """[n, w / model] column blocks -> [n / model, w] row blocks: one
        all_to_all."""
        m = self.model
        n, wc = cols.shape
        got = self.all_to_all(cols.reshape(m, n // m, wc))
        return got.transpose(0, 1).reshape(n // m, m * wc)

    def roll(self, block: torch.Tensor, k: int) -> torch.Tensor:
        """Row i of the result is global row i + k of the row-sharded
        array, cyclically (k < 0: row i - |k|), |k| at most the block's
        rows: the next rank's first k rows (or the previous rank's last
        |k|) come in as a halo, one all_gather of the k rows."""
        if k == 0:
            return block
        if self.model == 1:
            return torch.roll(block, -k, dims=0)
        R, j = block.shape[0], self.coords[1]
        if abs(k) > R:
            raise ValueError(f"a halo of {k} rows over blocks of {R}")
        if k > 0:
            halo = self.all_gather(block[:k])[(j + 1) % self.model]
            return torch.cat([block[k:], halo])
        halo = self.all_gather(block[R + k :])[(j - 1) % self.model]
        return torch.cat([halo, block[: R + k]])

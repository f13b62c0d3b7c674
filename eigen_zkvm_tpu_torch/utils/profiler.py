"""Per-stage wall-clock ticks for the port's prover.

Port of eigen_zkvm_tpu/utils/profiler.py with the same switches:
EIGEN_ZKVM_PROFILE=1 prints each stage, EIGEN_ZKVM_LOG emits JSON-lines
records (utils/structlog.py), EIGEN_ZKVM_SYNC=1 drains the CUDA device with
`torch.cuda.synchronize` at every tick (kernels return before the device
finishes), and EIGEN_ZKVM_MEMLOG=1 adds the device's allocated and peak
bytes.  A caller that wants the numbers passes `on=True` and reads `stages`.
"""
from __future__ import annotations

import os
import time

import torch

from . import structlog


def enabled() -> bool:
    return bool(os.environ.get("EIGEN_ZKVM_PROFILE"))


def sync_enabled() -> bool:
    return bool(os.environ.get("EIGEN_ZKVM_SYNC"))


class Prof:
    def __init__(self, name: str, device: torch.device | None = None,
                 on: bool | None = None):
        self.name = name
        self.pr = enabled()
        self.on = self.pr or structlog.enabled() or bool(on)
        cuda = device is not None and device.type == "cuda"
        self.device = device if cuda else None
        self.sync = cuda and sync_enabled()
        self.stages: list[tuple[str, float]] = []
        self.t0 = self.last = time.perf_counter()

    def _mem(self) -> str:
        if self.device is None or not os.environ.get("EIGEN_ZKVM_MEMLOG"):
            return ""
        used = torch.cuda.memory_allocated(self.device)
        peak = torch.cuda.max_memory_allocated(self.device)
        return f" mem={used / 1e9:.2f}/{peak / 1e9:.2f}GB"

    def tick(self, stage: str):
        if not self.on:
            return
        if self.sync:
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stages.append((stage, now - self.last))
        if self.pr:
            print(f"[profile] {self.name}: {stage}: {now - self.last:.3f}s"
                  f"{self._mem()}", flush=True)
        structlog.log_event(f"{self.name}.stage", stage=stage,
                            wall=round(now - self.last, 4))
        self.last = now

    def done(self):
        if not self.on:
            return
        total = time.perf_counter() - self.t0
        if self.pr:
            print(f"[profile] {self.name}: TOTAL {total:.3f}s", flush=True)
        structlog.log_event(f"{self.name}.total", wall=round(total, 4))

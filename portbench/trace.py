"""What a traced run reads: the device's intervals from torch.profiler's raw
Kineto events, their union, the idle gaps between them, and the prover's
stage ticks.

The events are read from `profiler.kineto_results` (torch.profiler's own
event objects are never built: a proof launches some hundred thousand
kernels).  Their clock is the wall clock in ns (time.time_ns)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# device rows that are the profiler's own work
_PROFILER_ROWS = ("Activity Buffer Request",)


@dataclass
class Events:
    """Device intervals [start, end) in ns, with their names."""
    names: list
    start: np.ndarray
    end: np.ndarray

    @property
    def kernels(self) -> np.ndarray:
        """Mask of the kernels (every interval but copies and sets)."""
        return np.array([not n.startswith(("Memcpy", "Memset"))
                         for n in self.names], dtype=bool)

    def seconds_of(self, pattern: str) -> float:
        """Device seconds of the intervals whose name holds `pattern`."""
        mask = np.array([pattern in n for n in self.names], dtype=bool)
        return float((self.end[mask] - self.start[mask]).sum()) / 1e9


def device_events(tp) -> Events:
    """The device intervals of a finished torch.profiler run."""
    from torch.autograd import DeviceType

    names, start, dur = [], [], []
    for e in tp.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and \
                e.name() not in _PROFILER_ROWS:
            names.append(e.name())
            start.append(e.start_ns())
            dur.append(e.duration_ns())
    start = np.asarray(start, dtype=np.int64)
    return Events(names, start, start + np.asarray(dur, dtype=np.int64))


def union(start: np.ndarray, end: np.ndarray, lo: int, hi: int):
    """The union of intervals clipped to [lo, hi), as disjoint sorted
    (starts, ends)."""
    s, e = np.clip(start, lo, hi), np.clip(end, lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if s.size == 0:
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, s.size - 1]
    return s[first], reach[last]


def gaps(seg_start: np.ndarray, seg_end: np.ndarray, lo: int, hi: int):
    """The complement of disjoint sorted intervals within [lo, hi)."""
    gs = np.r_[lo, seg_end]
    ge = np.r_[seg_start, hi]
    keep = ge > gs
    return gs[keep], ge[keep]


@dataclass
class Window:
    """One traced window: its wall-clock bounds (ns), its device events and
    each proof's stage ticks [(stage, start_ns, end_ns)]."""
    open_ns: int
    close_ns: int
    events: Events
    stages: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.close_ns - self.open_ns) / 1e9

    def busy_seconds(self) -> float:
        s, e = union(self.events.start, self.events.end, self.open_ns,
                     self.close_ns)
        return float((e - s).sum()) / 1e9

    def top_ops(self, k: int = 10) -> list:
        """The k device operations that took most time: [name, seconds]."""
        tot: dict[str, int] = {}
        for n, d in zip(self.events.names,
                        (self.events.end - self.events.start).tolist()):
            tot[n] = tot.get(n, 0) + d
        rows = sorted(tot.items(), key=lambda r: -r[1])[:k]
        return [[n[:160], ns / 1e9] for n, ns in rows]

    def idle_by_stage(self, k: int = 10) -> list:
        """Idle device time by the prover stage the host was in (the stage
        whose interval holds the gap's middle; "between proofs" for the
        serializer and the hand-off of the next trace): the k largest,
        [label, seconds]."""
        s, e = union(self.events.start, self.events.end, self.open_ns,
                     self.close_ns)
        gs, ge = gaps(s, e, self.open_ns, self.close_ns)
        st = sorted(self.stages, key=lambda r: r[1])
        starts = np.asarray([r[1] for r in st], dtype=np.int64)
        ends = np.asarray([r[2] for r in st], dtype=np.int64)
        mid = (gs + ge) // 2
        at = np.searchsorted(starts, mid, side="right") - 1
        tot: dict[str, int] = {}
        for g, i, m in zip((ge - gs).tolist(), at.tolist(), mid.tolist()):
            label = st[i][0] if i >= 0 and m < ends[i] else "between proofs"
            tot[label] = tot.get(label, 0) + g
        rows = sorted(tot.items(), key=lambda r: -r[1])[:k]
        return [[n, ns / 1e9] for n, ns in rows]

"""Bounded per-thread trace ring: drop-not-block on overflow.

One ``TraceBuffer`` per recording thread (the tracer hands them out via
``threading.local``), so the hot path is an unlocked list append by the
owning thread. When the buffer is full, new records are *dropped* and
counted — recording must never block or grow unboundedly, whatever the
consumer is doing (the decode loop records from inside completion
continuations; a stall there is a stall of the whole engine).

Draining snapshots the list from another thread. CPython list append /
``list(...)`` are atomic under the GIL, so the snapshot is a consistent
prefix without any lock on the recording side.
"""
from __future__ import annotations

import threading
from typing import List, Tuple

from repro_torch.obs.events import Event

#: raw ring record: (ts, dur, kind, rid, src, meta) — Event minus tid.
Record = Tuple[float, float, str, int, str, object]


class TraceBuffer:
    """Single-writer bounded event list with a drop counter."""

    __slots__ = ("capacity", "events", "dropped", "tid")

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self.events: List[Record] = []
        self.dropped = 0
        self.tid = threading.get_ident()

    def record(self, rec: Record) -> None:
        """Append one record; drop (and count) when full. Never blocks."""
        if len(self.events) < self.capacity:
            self.events.append(rec)
        else:
            self.dropped += 1

    def snapshot(self) -> List[Event]:
        """Consistent copy as ``Event``s (safe from any thread)."""
        tid = self.tid
        return [Event(*rec, tid) for rec in list(self.events)]

    def __len__(self) -> int:
        return len(self.events)

"""The global tracer: default-off, sampling, per-thread rings, histograms.

Instrumentation sites across the runtime follow one pattern::

    from repro_torch.obs import tracer as _obs
    ...
    tr = _obs.TRACE
    if tr is not None and tr.want(rid):
        tr.evt(kind, rid, "engine", meta=...)

``TRACE`` is ``None`` unless tracing was started, so the default-off hot
path costs one module-attribute load and a ``None`` check. Continuation
lifecycle sites additionally gate on ``cont.t_posted is not None`` — a
continuation is traced end-to-end iff it was sampled at registration,
which keeps the per-edge decision to a single attribute test.

Sampling is deterministic by id (Knuth multiplicative hash), so every
component traces the *same* subset of requests/continuations and
timelines stay complete under sampling.

Enable programmatically (``obs.start(sample=...)``) or via the
environment: ``REPRO_TRACE=1`` (optionally ``REPRO_TRACE_SAMPLE=0.25``,
``REPRO_TRACE_CAPACITY=65536``) arms tracing at import time, which is
how ``examples/serve_trace.py`` and ad-hoc runs switch it on without
code changes.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.buffer import TraceBuffer
from repro_torch.obs.events import (CONT_RAN, EDGE_COMPLETE_TO_ENQUEUE,
                              EDGE_COMPLETE_TO_RUN, EDGE_ENQUEUE_TO_RUN,
                              EDGE_POST_TO_COMPLETE, Event, policy_key)
from repro_torch.obs.hist import Histogram

DEFAULT_CAPACITY = 1 << 16


class Tracer:
    """One tracing session: buffers, histograms, clock, sampling."""

    def __init__(self, *, capacity: int = DEFAULT_CAPACITY,
                 sample: float = 1.0) -> None:
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.capacity = capacity
        self.sample = sample
        self._threshold = int(sample * 0xFFFFFFFF)
        self.clock = time.monotonic   # matches Request arrival/token stamps
        self._tls = threading.local()
        self._buffers: List[TraceBuffer] = []
        self._buffers_lock = threading.Lock()
        self._hist: Dict[Tuple[str, str], Histogram] = {}
        self._hist_lock = threading.Lock()
        self.t0 = self.clock()

    # ------------------------------------------------------------ recording
    def now(self) -> float:
        return self.clock()

    def want(self, rid: int) -> bool:
        """Deterministic per-id sampling decision."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return ((rid * 2654435761) & 0xFFFFFFFF) <= self._threshold

    def _buf(self) -> TraceBuffer:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = TraceBuffer(self.capacity)
            self._tls.buf = buf
            with self._buffers_lock:
                self._buffers.append(buf)
        return buf

    def evt(self, kind: str, rid: int = -1, src: str = "", *,
            dur: float = 0.0, meta=None, ts: Optional[float] = None) -> None:
        """Record one event on the calling thread's ring (never blocks)."""
        if ts is None:
            ts = self.clock()
        self._buf().record((ts, dur, kind, rid, src, meta))

    # ------------------------------------------------- lifecycle histograms
    def observe(self, edge: str, pkey: str, seconds: float) -> None:
        key = (edge, pkey)
        h = self._hist.get(key)
        if h is None:
            with self._hist_lock:
                h = self._hist.setdefault(key, Histogram())
        h.observe(seconds * 1e6)

    def lifecycle_ran(self, cont, t_run: float) -> None:
        """The callback-ran edge: emit the span + all inter-edge latencies.

        Called by ``Scheduler.run_one`` after the callback returns, only
        for continuations stamped at registration (``t_posted`` set).
        """
        t_end = self.clock()
        pkey = policy_key(cont.policy)
        self.evt(CONT_RAN, cont.seqno, "core", ts=t_run, dur=t_end - t_run,
                 meta=pkey)
        t_posted, t_ready = cont.t_posted, cont.t_ready
        t_enq = cont.t_enqueued
        if t_ready is not None:
            if t_posted is not None:
                self.observe(EDGE_POST_TO_COMPLETE, pkey, t_ready - t_posted)
            self.observe(EDGE_COMPLETE_TO_RUN, pkey, t_run - t_ready)
            if t_enq is not None:
                self.observe(EDGE_COMPLETE_TO_ENQUEUE, pkey, t_enq - t_ready)
        if t_enq is not None:
            self.observe(EDGE_ENQUEUE_TO_RUN, pkey, t_run - t_enq)

    # -------------------------------------------------------------- reading
    @property
    def dropped(self) -> int:
        with self._buffers_lock:
            bufs = list(self._buffers)
        return sum(b.dropped for b in bufs)

    def drain(self) -> List[Event]:
        """Merged, time-sorted snapshot of every thread's ring."""
        with self._buffers_lock:
            bufs = list(self._buffers)
        events: List[Event] = []
        for b in bufs:
            events.extend(b.snapshot())
        events.sort(key=lambda ev: ev.ts)
        return events

    def histograms(self) -> Dict[Tuple[str, str], Histogram]:
        with self._hist_lock:
            return dict(self._hist)


#: the global tracing session; ``None`` = tracing off (the common case).
TRACE: Optional[Tracer] = None
_state_lock = threading.Lock()


def start(*, capacity: int = DEFAULT_CAPACITY,
          sample: float = 1.0) -> Tracer:
    """Arm tracing globally; returns the (new) active ``Tracer``."""
    global TRACE
    with _state_lock:
        TRACE = Tracer(capacity=capacity, sample=sample)
        return TRACE


def stop() -> Optional[Tracer]:
    """Disarm tracing; returns the finished session (drain it for data)."""
    global TRACE
    with _state_lock:
        tr, TRACE = TRACE, None
        return tr


def active() -> Optional[Tracer]:
    return TRACE


def is_enabled() -> bool:
    return TRACE is not None


if os.environ.get("REPRO_TRACE", "") not in ("", "0"):  # pragma: no cover
    start(sample=float(os.environ.get("REPRO_TRACE_SAMPLE", "1.0")),
          capacity=int(os.environ.get("REPRO_TRACE_CAPACITY",
                                      str(DEFAULT_CAPACITY))))

"""Heartbeat failure detector built on continuations.

Every rank periodically sends a heartbeat message; the monitor keeps one
pre-posted receive per rank whose *continuation* records liveness and
re-posts itself (the paper's re-post pattern), plus a sweep chained on the
``Promise`` front-end: ``engine.wrap(TimerOp).then(sweep)`` re-arms itself
each tick. Failures fire the registered callback exactly once per rank —
an elastic controller reacts by shrinking the mesh (the reference's
``runtime.elastic``, not ported).

Both registrations ride a plain CR with per-registration
``ContinueFlags(enqueue_complete=True)`` — an already-delivered heartbeat
or already-expired timer still flows through the continuation path.

Host-only: heartbeats are small control messages and touch no device.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core import (ANY_SOURCE, ContinueFlags, Engine, Status,
                              TimerOp, Transport)

HEARTBEAT_TAG = 9101

_HB_FLAGS = ContinueFlags(enqueue_complete=True)


class HeartbeatSender:
    """Rank-side: call ``beat()`` from the rank's main loop (cheap isend)."""

    def __init__(self, transport: Transport, rank: int, monitor_rank: int,
                 interval_s: float = 0.01) -> None:
        self.transport = transport
        self.rank = rank
        self.monitor_rank = monitor_rank
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if now - self._last >= self.interval_s:
            self._last = now
            self.transport.isend(self.rank, self.monitor_rank, HEARTBEAT_TAG,
                                 ("hb", self.rank, now))


class HeartbeatMonitor:
    def __init__(self, transport: Transport, engine: Engine, rank: int,
                 watched: List[int], timeout_s: float = 0.2,
                 sweep_interval_s: float = 0.05,
                 on_failure: Optional[Callable[[int], None]] = None,
                 stall_guard_s: Optional[float] = None) -> None:
        self.transport = transport
        self.engine = engine
        self.rank = rank
        self.timeout_s = timeout_s
        self.sweep_interval_s = sweep_interval_s
        self.on_failure = on_failure or (lambda r: None)
        # Self-suspicion guard: when the monitor shares its driver thread
        # with heavy compute (the router's loop jit-compiles replica
        # steps), a long gap between sweeps means beats COULD NOT be
        # observed — silence proves nothing. With ``stall_guard_s`` set,
        # a sweep arriving more than that long after the previous one
        # restarts every silence clock instead of flagging; genuine
        # deaths are still caught one quiet timeout window later.
        self.stall_guard_s = stall_guard_s
        self._last_sweep = time.monotonic()
        # ``last_seen`` is seeded lazily by the first *actual* beat — a
        # construction-time timestamp would vouch for ranks the monitor
        # has never heard from. Until a rank beats, the sweep measures
        # silence against its ``watch()`` time instead, so a rank that is
        # dead on arrival is still flagged one timeout after watch-start.
        self.last_seen: Dict[int, float] = {}
        self._watch_start: Dict[int, float] = {}
        self.failed: Set[int] = set()
        self._lock = threading.Lock()
        self._stopped = False
        self._sweep_error: Optional[BaseException] = None
        for r in watched:
            self.watch(r)
        self.cr = engine.continue_init()
        self._post_recv()
        self._post_sweep()

    # ------------------------------------------------------- watch set
    def watch(self, rank: int, now: Optional[float] = None) -> None:
        """(Re-)watch ``rank``: its silence clock starts now. Re-watching
        a failed rank clears its failure so recovery can be observed."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._watch_start[rank] = now
            self.last_seen.pop(rank, None)
            self.failed.discard(rank)

    def unwatch(self, rank: int) -> None:
        """Stop watching ``rank`` (elastic shrink: a rank the controller
        already removed must not re-fire ``on_failure``)."""
        with self._lock:
            self._watch_start.pop(rank, None)
            self.last_seen.pop(rank, None)
            self.failed.discard(rank)

    @property
    def watched(self) -> List[int]:
        with self._lock:
            return sorted(self._watch_start)

    # heartbeat receive → record → re-post (continuation body starts new op)
    def _post_recv(self) -> None:
        op = self.transport.irecv(self.rank, source=ANY_SOURCE,
                                  tag=HEARTBEAT_TAG)
        self.engine.continue_when(op, self._on_beat, status=[None],
                                  cr=self.cr, flags=_HB_FLAGS)

    def _on_beat(self, statuses, _):
        status: Status = statuses[0]
        if status.test_cancelled() or self._stopped:
            return
        _, rank, _ = status.payload
        with self._lock:
            if rank in self._watch_start:
                self.last_seen[rank] = time.monotonic()
        self._post_recv()

    # periodic sweep via the awaitable front-end: a promise over a TimerOp,
    # whose then-handler re-arms the chain (registered on this monitor's CR
    # so ``progress()`` — one ``cr.test()`` — drives the poll-mode timer).
    # A raising sweep handler (e.g. a broken user on_failure callback) is
    # caught and re-raised from the next progress() call — same surfacing
    # the raw-callback CR error policy gave before the promise migration.
    def _post_sweep(self) -> None:
        (self.engine.wrap(TimerOp(self.sweep_interval_s), cr=self.cr)
         .then(self._on_sweep).catch(self._record_sweep_error))

    def _record_sweep_error(self, exc: BaseException) -> None:
        self._sweep_error = exc

    def _on_sweep(self, _value=None):
        if self._stopped:
            return
        now = time.monotonic()
        gap, self._last_sweep = now - self._last_sweep, now
        if self.stall_guard_s is not None and gap > self.stall_guard_s:
            with self._lock:
                for rank in self._watch_start:
                    self._watch_start[rank] = now
                    self.last_seen.pop(rank, None)
            self._post_sweep()
            return
        newly_failed = []
        with self._lock:
            for rank, started in self._watch_start.items():
                seen = self.last_seen.get(rank, started)
                if rank not in self.failed and now - seen > self.timeout_s:
                    self.failed.add(rank)
                    newly_failed.append(rank)
        for rank in newly_failed:
            self.on_failure(rank)
        self._post_sweep()

    def progress(self) -> None:
        self.cr.test()
        if self._sweep_error is not None:
            err, self._sweep_error = self._sweep_error, None
            raise err

    def stop(self) -> None:
        self._stopped = True

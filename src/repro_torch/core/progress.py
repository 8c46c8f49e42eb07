"""Completion discovery — poll scans, progress thread, waiter threads.

This is the *discovery* third of the engine split (see ``core.scheduler``
for the execution third; ``core.engine`` is the facade). It mirrors the
paper's "progress": completions are found either

* **push** — the completing thread publishes via ``Completable._complete``
  (host futures, transport matches, CR drains); no Progress involvement, or
* **poll** — poll-mode ops (CUDA event, timers, predicates)
  are discovered by ``scan()`` calls, which every engine entry point makes
  (``tick``, ``cr.test/wait``, transport calls) — the analogue of "any
  thread calling into MPI" finding the operation complete, or
* **waiters** — for CRs with ``thread="any"``, dedicated threads that
  *block* on array readiness (the MPI-internal progress thread analogue,
  and the "MPI progress for all" direction: discovery as a first-class,
  swappable service rather than a side effect of application calls).

The optional internal progress thread periodically scans and drains the
scheduler, so completions are noticed even if no application thread calls
into the engine.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from typing import List, Optional

from repro_torch.core.completable import Completable, TensorOp
from repro_torch.core.scheduler import Scheduler
from repro_torch.obs import events as _obs_events
from repro_torch.obs import tracer as _obs


class Progress:
    """Discovery component: owns the poll list and the internal threads."""

    def __init__(self, scheduler: Scheduler, *,
                 progress_thread: bool = False,
                 progress_interval: float = 2e-4,
                 n_waiters: int = 0) -> None:
        self.scheduler = scheduler
        self._poll_ops: List[Completable] = []
        self._poll_lock = threading.Lock()
        self._shutdown = threading.Event()
        self.stats = {"poll_scans": 0, "waiter_blocks": 0}
        self._progress_thread: Optional[threading.Thread] = None
        if progress_thread:
            self._progress_thread = threading.Thread(
                target=self._progress_loop, args=(progress_interval,),
                name="contin-progress", daemon=True)
            self._progress_thread.start()
        self._waiter_q: "queue_mod.Queue[Optional[TensorOp]]" = queue_mod.Queue()
        self._waiters = [
            threading.Thread(target=self._waiter_loop,
                             name=f"contin-waiter-{i}", daemon=True)
            for i in range(n_waiters)]
        for w in self._waiters:
            w.start()

    @property
    def has_waiters(self) -> bool:
        return bool(self._waiters)

    # ------------------------------------------------------------- tracking
    def watch(self, op: Completable, *, use_waiter: bool = False) -> None:
        """Track a pending poll-mode op until a scan discovers it complete.

        ``use_waiter`` hands ``TensorOp``s to a blocking waiter thread
        instead (callers gate this on the CR's ``thread=any`` policy).
        """
        if use_waiter and self._waiters and isinstance(op, TensorOp):
            self._waiter_q.put(op)
            return
        with self._poll_lock:
            self._poll_ops.append(op)

    def scan(self) -> None:
        """Discover completions of poll-mode ops (cheap, lock-sliced)."""
        self.stats["poll_scans"] += 1
        tr = _obs.TRACE
        t0 = tr.now() if tr is not None else 0.0
        with self._poll_lock:
            ops = list(self._poll_ops)
        done_ops = [op for op in ops if op.done()]  # done() fires hooks
        if done_ops:
            done_set = set(map(id, done_ops))
            with self._poll_lock:
                self._poll_ops = [op for op in self._poll_ops
                                  if id(op) not in done_set]
            # only fruitful scans are recorded — empty polls would swamp
            # the ring without telling the timeline anything
            if tr is not None:
                tr.evt(_obs_events.PROGRESS_SCAN, -1, "core", ts=t0,
                       dur=tr.now() - t0, meta=len(done_ops))

    @property
    def watched(self) -> int:
        with self._poll_lock:
            return len(self._poll_ops)

    # ------------------------------------------------------ internal threads
    def _progress_loop(self, interval: float) -> None:
        self.scheduler.register_internal_thread()
        while not self._shutdown.wait(interval):
            self.scan()
            self.scheduler.drain()

    def _waiter_loop(self) -> None:
        self.scheduler.register_internal_thread()
        while True:
            op = self._waiter_q.get()
            if op is None or self._shutdown.is_set():
                break
            self.stats["waiter_blocks"] += 1
            op.block()               # fires hooks on this internal thread
            self.scheduler.drain()   # eligible only for thread=any CRs

    # -------------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        self._shutdown.set()
        for _ in self._waiters:
            self._waiter_q.put(None)
        for w in self._waiters:
            w.join(timeout=2.0)
        if self._progress_thread is not None:
            self._progress_thread.join(timeout=2.0)

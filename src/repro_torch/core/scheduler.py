"""Pluggable continuation schedulers — execution/eligibility/ready-queue.

This is the *execution* third of the engine split (paper §3.1, plus the
fibers-vs-pthreads observation that execution policy should be decoupled
from the completion interface):

    Progress  (core.progress)   — *discovers* completions,
    Scheduler (this module)     — decides *where/when* ready continuations
                                  execute and runs them,
    Engine    (core.engine)     — thin facade wiring the two plus the
                                  info-key policy and the registration API.

A ``Scheduler`` owns the ready queue(s) of non-``poll_only`` continuations
and the thread-eligibility policy:

* no nested execution — a callback never runs inside another callback
  (paper §3.1),
* no execution inside ``continue_when``/``continue_all`` — registration may
  happen inside an application critical region (paper §3.1),
* engine-internal threads (progress thread, waiters, transport delivery)
  run only continuations of ``thread="any"`` CRs (paper §3.5).

Two implementations:

* ``FifoScheduler``     — one shared queue + one lock; global FIFO order.
  Simple and fair, but every ``submit``/``drain`` on the hot path takes the
  same lock from every thread.
* ``AffinityScheduler`` — per-thread local queues plus a shared overflow
  queue with work stealing. A completion discovered on thread *T* lands on
  *T*'s local queue (usually drained inline by *T* a few instructions
  later) without touching any shared lock; ineligible or stolen work
  migrates through the shared queue, so nothing strands on a thread that
  never re-enters the engine.

Every queue is a ``core.continuation.ClassDeque``: registrations with the
per-registration ``priority`` flag > 0 drain ahead of normal work but
stay FIFO within their priority class.

Select per engine: ``Engine(scheduler="fifo"|"affinity")`` or pass a
``Scheduler`` instance.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from repro_torch.core.continuation import (ClassDeque, Continuation,
                                     ContinuationRequest)
from repro_torch.core.info import THREAD_ANY
from repro_torch.obs import tracer as _obs

_TLS = threading.local()


def in_callback() -> bool:
    """True while the current thread is executing a continuation body."""
    return getattr(_TLS, "depth", 0) > 0


def in_registration() -> bool:
    """True while the current thread is inside continue_when/continue_all."""
    return getattr(_TLS, "registering", 0) > 0


class registration_guard:
    """Suppress inline execution while hooks are installed (paper §3.1)."""

    def __enter__(self):
        _TLS.registering = getattr(_TLS, "registering", 0) + 1
        return self

    def __exit__(self, *exc):
        _TLS.registering -= 1
        return False


class Scheduler:
    """Base class: the drain/eligibility machinery over queue primitives.

    Subclasses supply ``_push`` / ``_pop`` / ``_requeue`` (and may override
    ``pending`` for introspection).
    """

    name = "base"

    def __init__(self, *, inline_limit: int = 16) -> None:
        #: max continuations drained inline per discovery (bounds latency of
        #: the discovering thread; the full queue drains on test/tick)
        self.inline_limit = inline_limit
        self._internal_threads: set[int] = set()
        self.stats = {"inline_runs": 0, "queued_runs": 0}

    # ------------------------------------------------------ queue primitives
    def _push(self, cont: Continuation) -> None:
        raise NotImplementedError

    def _pop(self) -> Optional[Continuation]:
        raise NotImplementedError

    def _requeue(self, conts: Sequence[Continuation]) -> None:
        raise NotImplementedError

    @property
    def pending(self) -> int:
        raise NotImplementedError

    # ------------------------------------------------------- thread policy
    def register_internal_thread(self) -> None:
        """Mark the calling thread as engine-internal (thread=any gating)."""
        self._internal_threads.add(threading.get_ident())

    def thread_eligible(self, cr: ContinuationRequest) -> bool:
        """CR-level eligibility (pre-flags compat; prefer ``eligible``)."""
        if in_callback():
            return False  # no nested continuation execution (paper §3.1)
        if threading.get_ident() in self._internal_threads:
            return cr.info.thread == THREAD_ANY
        return True

    def eligible(self, cont: Continuation, inline: bool) -> bool:
        """May the *current thread* execute this continuation *now*?

        Resolved per registration (``cont.policy``): ``thread`` gates
        engine-internal threads; ``immediate`` opts out of the
        registration guard; ``defer_complete`` vetoes the inline
        discovery path entirely.
        """
        if in_callback():
            return False  # no nested continuation execution (paper §3.1)
        if in_registration() and not cont.policy.immediate:
            return False  # inside continue_[all] (paper §3.1)
        if inline and cont.policy.defer_complete:
            return False  # must wait for a drain from an entry point
        if threading.get_ident() in self._internal_threads:
            return cont.policy.thread == THREAD_ANY
        return True

    # ----------------------------------------------------------- execution
    def submit(self, cont: Continuation) -> None:
        """A continuation of a non-poll_only registration became ready."""
        self._push(cont)
        if in_registration() and not cont.policy.immediate:
            return  # never execute inside continue_[all] (paper §3.1)
        # Low-latency path: run inline if the current thread is eligible.
        self.drain(limit=self.inline_limit, inline=True)

    def run_one(self, cont: Continuation) -> None:
        # lifecycle edge 4/4: callback execution. Stamped only for
        # continuations sampled at registration; the span + all four
        # inter-edge histograms are emitted by ``lifecycle_ran``.
        tr = _obs.TRACE
        t_run = (tr.now() if tr is not None and cont.t_posted is not None
                 else None)
        _TLS.depth = getattr(_TLS, "depth", 0) + 1
        try:
            err = cont.run()
        finally:
            _TLS.depth -= 1
        if t_run is not None:
            tr.lifecycle_ran(cont, t_run)
        cont.cr._deregister(err, cont.policy)

    def drain(self, limit: int = -1, inline: bool = False,
              for_cr: Optional[ContinuationRequest] = None,
              cr_limit: int = -1) -> int:
        """Run ready continuations from the queue(s).

        ``cr_limit`` caps executions belonging to ``for_cr`` (max_poll during
        a test of that CR). Ineligible continuations (thread policy) are
        requeued for an eligible thread.
        """
        ran = 0
        ran_for_cr = 0
        requeue: List[Continuation] = []
        while limit < 0 or ran < limit:
            cont = self._pop()
            if cont is None:
                break
            if not self.eligible(cont, inline):
                requeue.append(cont)
                # inline discovery on an ineligible thread: stop early
                if inline:
                    break
                continue
            if for_cr is not None and cont.cr is for_cr and cr_limit >= 0 \
                    and ran_for_cr >= cr_limit:
                # over budget for the tested CR: park it, but keep going —
                # other CRs' ready continuations behind it must still run
                # (each queue item is popped at most once per drain; the
                # requeue list is only flushed on exit, so no livelock)
                requeue.append(cont)
                continue
            self.run_one(cont)
            ran += 1
            if for_cr is not None and cont.cr is for_cr:
                ran_for_cr += 1
            self.stats["inline_runs" if inline else "queued_runs"] += 1
        if requeue:
            self._requeue(requeue)
        return ran

    def drain_cr_queue(self, cr: ContinuationRequest, limit: int) -> int:
        """Run a poll_only CR's private ready queue (inside cr.test())."""
        ran = 0
        while limit < 0 or ran < limit:
            with cr._lock:
                cont = cr._ready_q.pop()
            if cont is None:
                break
            self.run_one(cont)
            ran += 1
        return ran


class FifoScheduler(Scheduler):
    """The reference policy: one shared lock, one ``ClassDeque`` —
    global FIFO within each priority class (priority>0 drains first; see
    ``ClassDeque`` for why jumping must not reorder a class)."""

    name = "fifo"

    def __init__(self, *, inline_limit: int = 16) -> None:
        super().__init__(inline_limit=inline_limit)
        self._ready = ClassDeque()
        self._lock = threading.Lock()

    def _push(self, cont: Continuation) -> None:
        with self._lock:
            self._ready.push(cont)

    def _pop(self) -> Optional[Continuation]:
        with self._lock:
            return self._ready.pop()

    def _requeue(self, conts: Sequence[Continuation]) -> None:
        with self._lock:
            for cont in reversed(conts):
                self._ready.push_front(cont)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._ready)


class _LocalQueue:
    __slots__ = ("lock", "q")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.q = ClassDeque()


class AffinityScheduler(Scheduler):
    """Per-thread affinity queues with work stealing.

    The hot ``submit``→inline-``drain`` path (a completion discovered and
    executed on the same thread, the common case by far) touches only the
    discovering thread's own queue — no shared-lock contention. Ineligible
    continuations migrate to the shared overflow deque; drains on any
    thread fall back to the shared deque and then *steal* from other
    threads' local queues, so no continuation can strand on a thread that
    never calls into the engine again.
    """

    name = "affinity"

    def __init__(self, *, inline_limit: int = 16) -> None:
        super().__init__(inline_limit=inline_limit)
        self._locals: Dict[int, _LocalQueue] = {}
        self._locals_lock = threading.Lock()
        self._shared = ClassDeque()      # overflow (class-FIFO, like all)
        self._shared_lock = threading.Lock()
        self.stats["local_pushes"] = 0
        self.stats["shared_pushes"] = 0
        self.stats["steals"] = 0

    def _my_queue(self) -> _LocalQueue:
        tid = threading.get_ident()
        lq = self._locals.get(tid)
        if lq is None:
            with self._locals_lock:
                lq = self._locals.setdefault(tid, _LocalQueue())
        return lq

    def _push(self, cont: Continuation) -> None:
        # Internal threads park work on the shared deque: their local queue
        # would only ever be drained under the thread=any policy.
        if threading.get_ident() in self._internal_threads:
            with self._shared_lock:
                self._shared.push(cont)
            self.stats["shared_pushes"] += 1
            return
        lq = self._my_queue()
        with lq.lock:
            lq.q.push(cont)
        self.stats["local_pushes"] += 1

    def _pop(self) -> Optional[Continuation]:
        # 1. own local queue (cache-hot, uncontended in the common case)
        lq = self._locals.get(threading.get_ident())
        if lq is not None:
            with lq.lock:
                cont = lq.q.pop()
            if cont is not None:
                return cont
        # 2. shared overflow
        with self._shared_lock:
            cont = self._shared.pop()
        if cont is not None:
            return cont
        # 3. steal from another thread's local queue
        with self._locals_lock:
            victims = list(self._locals.values())
        for victim in victims:
            if victim is lq:
                continue
            with victim.lock:
                cont = victim.q.pop()
            if cont is not None:
                self.stats["steals"] += 1
                return cont
        return None

    def _requeue(self, conts: Sequence[Continuation]) -> None:
        # Requeued work was ineligible on this thread — publish it where any
        # other thread will find it first.
        with self._shared_lock:
            for cont in reversed(conts):
                self._shared.push_front(cont)

    @property
    def pending(self) -> int:
        with self._shared_lock:
            n = len(self._shared)
        with self._locals_lock:
            victims = list(self._locals.values())
        for lq in victims:
            with lq.lock:
                n += len(lq.q)
        return n


_SCHEDULERS = {
    FifoScheduler.name: FifoScheduler,
    AffinityScheduler.name: AffinityScheduler,
}


def make_scheduler(spec, *, inline_limit: int = 16) -> Scheduler:
    """Resolve a scheduler spec: instance, class, or registered name."""
    if isinstance(spec, Scheduler):
        return spec
    if isinstance(spec, type) and issubclass(spec, Scheduler):
        return spec(inline_limit=inline_limit)
    try:
        cls = _SCHEDULERS[spec]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {spec!r}; known: {sorted(_SCHEDULERS)}"
        ) from None
    return cls(inline_limit=inline_limit)

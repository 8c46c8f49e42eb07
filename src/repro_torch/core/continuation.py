"""Continuations and continuation requests (paper §2–3).

A ``Continuation`` = callback *body* + *context* (``cb_data``) attached to one
or more active operations (``continue_when`` / ``continue_all``); it becomes
*ready* when the last of its operations completes and is *executed* exactly
once, after which it is deregistered from its ``ContinuationRequest``.

``ContinuationRequest`` (CR) is the persistent-request-like aggregator with
the Fig. 1 state machine::

    INITIALIZED/ INACTIVE --register--> ACTIVE_REFERENCED
    ACTIVE_REFERENCED --last deregistered--> ACTIVE_IDLE
    ACTIVE_IDLE --register--> ACTIVE_REFERENCED
    ACTIVE_IDLE --completion call (test/wait)--> COMPLETE
    COMPLETE --register--> ACTIVE_REFERENCED
    any active state --free()--> released once the set drains

Thread-safety contract (paper §3.3): any number of threads may register
concurrently; at most one thread may test/wait a given CR at a time (we
detect violations and raise). Callbacks never run nested inside other
callbacks (paper §3.1).

Per-registration control (the API-redesign layer, ``core.flags``): each
``Continuation`` carries a ``ResolvedPolicy`` — the CR's ``ContinueInfo``
defaults overridden by any ``ContinueFlags`` passed at registration — so
routing (poll_only queue vs scheduler), thread eligibility, inline
execution, and error surfacing are decided per registration, not per CR.
"""
from __future__ import annotations

import collections
import enum
import threading
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.core.completable import Completable
from repro_torch.core.flags import ResolvedPolicy, resolve
from repro_torch.core.info import ContinueInfo, make_info
from repro_torch.core.status import OpState, Status
from repro_torch.obs import events as _obs_events
from repro_torch.obs import tracer as _obs

# Callback signature mirrors MPIX_Continue_cb_function(statuses, cb_data).
ContinueCallback = Callable[[Optional[List[Status]], Any], None]


class CRState(enum.Enum):
    INACTIVE = "inactive"            # initialized, nothing ever registered
    ACTIVE_REFERENCED = "active_referenced"
    ACTIVE_IDLE = "active_idle"
    COMPLETE = "complete"
    FREED = "freed"                  # free() called; released when drained


class ConcurrentCompletionError(RuntimeError):
    """Two threads tested/waited the same CR simultaneously (paper §3.3)."""


class CallbackError(RuntimeError):
    """A continuation callback raised; re-raised from test/wait (on_error="raise")."""


class ContinuationState(enum.Enum):
    WAITING = "waiting"    # some ops outstanding
    READY = "ready"        # all ops complete, callback not yet run
    RUNNING = "running"
    DONE = "done"


class ClassDeque:
    """Ready-queue primitive shared by every continuation queue: two FIFO
    deques split by priority class. ``priority > 0`` registrations drain
    first but stay FIFO *within* their class — priority jumping must
    never reorder continuations from the same source (e.g. a serve
    request's consecutive step completions), which a naive
    ``appendleft`` would turn LIFO. Not thread-safe: callers hold their
    own lock.
    """

    __slots__ = ("hi", "lo")

    def __init__(self) -> None:
        self.hi: collections.deque["Continuation"] = collections.deque()
        self.lo: collections.deque["Continuation"] = collections.deque()

    def _class(self, cont: "Continuation") -> collections.deque:
        return self.hi if cont.policy.priority > 0 else self.lo

    def push(self, cont: "Continuation") -> None:
        self._class(cont).append(cont)

    def push_front(self, cont: "Continuation") -> None:
        """Requeue at the head of the continuation's class."""
        self._class(cont).appendleft(cont)

    def pop(self) -> Optional["Continuation"]:
        if self.hi:
            return self.hi.popleft()
        if self.lo:
            return self.lo.popleft()
        return None

    def __len__(self) -> int:
        return len(self.hi) + len(self.lo)

    def __bool__(self) -> bool:
        return bool(self.hi) or bool(self.lo)


class Continuation:
    """One registered callback, possibly spanning several operations."""

    __slots__ = ("cb", "cb_data", "ops", "statuses", "cr", "policy",
                 "_remaining", "_lock", "state", "seqno",
                 "t_posted", "t_ready", "t_enqueued")

    def __init__(self, cb: ContinueCallback, cb_data: Any,
                 ops: Sequence[Completable],
                 statuses: Optional[List[Status]],
                 cr: "ContinuationRequest",
                 policy: Optional[ResolvedPolicy] = None) -> None:
        self.cb = cb
        self.cb_data = cb_data
        self.ops = list(ops)
        # volatile_statuses: the caller's list may be reused immediately
        # after registration — snapshot into an engine-owned list that the
        # callback receives instead.
        self.policy = policy if policy is not None else resolve(cr.info, None)
        if self.policy.volatile_statuses and statuses is not None:
            statuses = list(statuses)
        self.statuses = statuses
        self.cr = cr
        self._remaining = len(ops)
        self._lock = threading.Lock()
        self.state = ContinuationState.WAITING
        self.seqno = 0  # set by the engine; FIFO fairness in ready queues
        # lifecycle-edge trace stamps; ``t_posted is not None`` == this
        # continuation was sampled at registration (obs.tracer)
        self.t_posted = None
        self.t_ready = None
        self.t_enqueued = None

    def _op_done(self, index: int, status: Status) -> None:
        """Hook target: operation ``index`` completed with ``status``."""
        ready = False
        with self._lock:
            if self.statuses is not None:
                self.statuses[index] = status
            self._remaining -= 1
            if self._remaining == 0 and self.state is ContinuationState.WAITING:
                self.state = ContinuationState.READY
                ready = True
        if ready:
            # lifecycle edge 2/4: the op group completed (WAITING -> READY)
            if self.t_posted is not None:
                tr = _obs.TRACE
                if tr is not None:
                    self.t_ready = ts = tr.now()
                    tr.evt(_obs_events.CONT_READY, self.seqno, "core", ts=ts)
            self.cr._continuation_ready(self)

    def hook_for(self, index: int):
        def _hook(op: Completable, status: Status, _i: int = index) -> None:
            self._op_done(_i, status)
        return _hook

    def run(self) -> Optional[BaseException]:
        """Execute the callback; returns the exception if one was raised."""
        self.state = ContinuationState.RUNNING
        try:
            self.cb(self.statuses, self.cb_data)
            return None
        except BaseException as exc:  # surfaced via CR error policy
            return exc
        finally:
            self.state = ContinuationState.DONE


class ContinuationRequest(Completable):
    """Aggregates active continuations; testable/waitable; itself completable.

    Create via ``Engine.continue_init`` (the ``MPIX_Continue_init`` analogue).
    """

    def __init__(self, engine, info: Optional[ContinueInfo] = None) -> None:
        super().__init__()
        self.engine = engine
        self.info = info if isinstance(info, ContinueInfo) else make_info(info)
        self.cr_state = CRState.INACTIVE
        self._active = 0                   # registered & not yet executed
        self._lock = threading.RLock()
        self._idle_cond = threading.Condition(self._lock)
        # ready-but-not-executed continuations for poll_only CRs; non-poll_only
        # CRs route ready continuations to the engine's shared queue.
        self._ready_q = ClassDeque()
        self._errors: list[BaseException] = []
        self._raise_q: list[BaseException] = []   # subset with on_error=raise
        self._released = False                    # free() fully drained
        self._tester: Optional[int] = None   # thread id currently in test/wait
        # one-shot "drained" observers (CR-as-completable chaining)
        self._empty_hooks: list[Callable[[], None]] = []
        self.stats = {"registered": 0, "executed": 0, "immediate": 0}

    # ------------------------------------------------------------------ state
    @property
    def active_count(self) -> int:
        return self._active

    def _register(self, count: int = 1) -> None:
        with self._lock:
            if self.cr_state is CRState.FREED:
                raise RuntimeError("cannot register continuations on a freed CR")
            self._active += count
            self.cr_state = CRState.ACTIVE_REFERENCED
            self.stats["registered"] += count

    def _continuation_ready(self, cont: Continuation) -> None:
        """Routing, resolved per registration: poll_only continuations go
        to this CR's private queue; others to the engine's scheduler (which
        may execute inline when the continuation's policy allows)."""
        # lifecycle edge 3/4: enqueued on a ready queue (either route)
        if cont.t_posted is not None:
            tr = _obs.TRACE
            if tr is not None:
                cont.t_enqueued = ts = tr.now()
                tr.evt(_obs_events.CONT_ENQUEUED, cont.seqno, "core", ts=ts)
        if cont.policy.poll_only:
            with self._lock:
                self._ready_q.push(cont)
        else:
            self.engine.scheduler.submit(cont)

    def _deregister(self, error: Optional[BaseException],
                    policy: Optional["ResolvedPolicy"] = None) -> None:
        """Called by the engine after a continuation executed.

        ``policy`` carries the registration's error policy; ``None`` falls
        back to the CR info default (pre-flags callers).
        """
        hooks: list[Callable[[], None]] = []
        on_error = self.info.on_error if policy is None else policy.on_error
        handler = on_error if callable(on_error) else None
        with self._lock:
            self._active -= 1
            self.stats["executed"] += 1
            if error is not None and handler is None:
                self._errors.append(error)
                if on_error == "raise":
                    self._raise_q.append(error)
            if self._active == 0:
                if self.cr_state is not CRState.FREED:
                    self.cr_state = CRState.ACTIVE_IDLE
                elif not self._released:
                    self._released = True
                hooks, self._empty_hooks = self._empty_hooks, []
                self._idle_cond.notify_all()
        if error is not None and handler is not None:
            try:
                handler(error)
            except Exception:
                with self._lock:       # a broken handler must not vanish
                    self._errors.append(error)
        for hook in hooks:
            hook()

    def _raise_pending_errors(self) -> None:
        if self._raise_q:
            with self._lock:
                errs, self._raise_q = self._raise_q, []
                raise_set = set(map(id, errs))
                self._errors = [e for e in self._errors
                                if id(e) not in raise_set]
            raise CallbackError(
                f"{len(errs)} continuation callback(s) raised; first error "
                f"follows") from errs[0]

    @property
    def errors(self) -> list[BaseException]:
        return list(self._errors)

    # --------------------------------------------------------------- test/wait
    def _acquire_tester(self) -> None:
        me = threading.get_ident()
        with self._lock:
            if self._tester is not None and self._tester != me:
                raise ConcurrentCompletionError(
                    "only one thread may test/wait a CR at a time (paper §3.3)")
            self._tester = me

    def _release_tester(self) -> None:
        with self._lock:
            self._tester = None

    def test(self) -> bool:
        """``MPI_Test`` analogue: progress + run eligible callbacks.

        Returns True iff no active continuations remain registered.
        """
        self._acquire_tester()
        try:
            self.engine._progress_for_test(self)
            with self._lock:
                flag = self._active == 0
                if flag and self.cr_state in (CRState.ACTIVE_IDLE, CRState.INACTIVE):
                    self.cr_state = CRState.COMPLETE
            self._raise_pending_errors()
            return flag
        finally:
            self._release_tester()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """``MPI_Wait`` analogue: block until all registered continuations ran."""
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.test():
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            # Block briefly; woken early when the active set drains. We still
            # loop to progress poll-mode ops that need scanning.
            with self._idle_cond:
                if self._active:
                    self._idle_cond.wait(timeout=self.engine.wait_poll_interval)

    def free(self) -> None:
        """``MPI_Request_free`` analogue.

        Drain contract: freeing a CR forbids *new* registrations but lets
        already-registered continuations run; the CR is *released* when the
        active set drains. A CR whose active set is already empty releases
        immediately — ``free()`` on an idle (or never-used) CR must not
        leave it waiting for a drain that will never happen.
        """
        hooks: list[Callable[[], None]] = []
        with self._lock:
            self.cr_state = CRState.FREED
            if self._active == 0 and not self._released:
                self._released = True
                hooks, self._empty_hooks = self._empty_hooks, []
                self._idle_cond.notify_all()
        for hook in hooks:
            hook()

    @property
    def released(self) -> bool:
        """True once ``free()`` was called and the active set has drained
        (immediately, if it was already empty)."""
        with self._lock:
            return self._released

    # ------------------------------------------------- CR as completable (op)
    # Attaching a continuation to a CR (paper §3.2) observes "the active set
    # became empty". One-shot, like any operation.
    def _poll(self) -> bool:
        with self._lock:
            return self._active == 0

    def add_ready_hook(self, hook) -> None:
        # Push path: notify when drained; immediate if already idle.
        with self._lock:
            if self._active:
                self._empty_hooks.append(lambda: hook(self, self._status))
                return
        hook(self, self._status)

    @property
    def supports_push(self) -> bool:
        return True

    def cancel(self) -> bool:  # CRs cannot be cancelled
        return False

"""The continuation engine facade — registration + policy wiring.

Execution model (paper §2–3), now split across three components:

* **Registration** (this module, ``continue_when`` / ``continue_all`` /
  ``continue_any`` / ``continue_some``): attach a callback to active
  op(s); if the group already satisfies its completion condition and the
  registration's *resolved policy* (CR ``ContinueInfo`` defaults
  overridden by per-registration ``ContinueFlags``) does not set
  ``enqueue_complete``, return ``flag=True`` *without* invoking the
  callback (immediate-completion fast path, paper §2.2). Otherwise the
  continuation is registered with the CR and hooks are installed on each
  op. All control knobs — fast path, routing, inline eligibility, thread
  and error policy — resolve per registration (``core.flags``); CR info
  keys are just the defaults.

* **Discovery** (``core.progress.Progress``): push-capable ops (host
  futures, transport messages, CRs) publish completion from whatever thread
  finished the work. Poll-mode ops (``TensorOp``) are discovered by
  progress scans: every engine entry point (``tick``, ``cr.test/wait``,
  transport calls) advances the scan, and an optional internal progress
  thread does too. CRs with ``thread="any"`` may additionally hand array
  ops to *waiter threads* that block on readiness.

* **Execution** (``core.scheduler.Scheduler``): a ready continuation runs
  (a) inline on the discovering thread when its resolved policy allows
  (not poll_only or defer_complete; thread policy admits the current
  thread; not nested inside another callback — paper §3.1), else (b) from
  the scheduler's ready queue(s) at the next engine entry of an eligible
  thread, else (c) for poll_only registrations, only inside ``cr.test()``
  — bounded by the CR's ``max_poll``.

``Engine`` wires a ``Scheduler`` (pluggable: ``"fifo"`` shared-deque FIFO
or ``"affinity"`` per-thread queues with stealing) to a ``Progress``
instance and exposes the paper's public API: ``continue_init``,
``continue_when``, ``continue_all``, ``tick``, and CR ``test/wait/free``.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, List, Optional, Sequence, Union

from repro_torch.core.completable import Completable, when_some
from repro_torch.core.continuation import Continuation, ContinuationRequest
from repro_torch.core.flags import ContinueFlags, make_flags, resolve
from repro_torch.core.info import THREAD_ANY, ContinueInfo, make_info
from repro_torch.core.progress import Progress
from repro_torch.core.scheduler import (Scheduler, in_callback, in_registration,
                                  make_scheduler, registration_guard)
from repro_torch.core.status import Status
from repro_torch.obs import events as _obs_events
from repro_torch.obs import tracer as _obs

# Back-compat aliases: these lived here before the scheduler split.
_in_callback = in_callback
_in_registration = in_registration


class Engine:
    """A continuations runtime instance. One per process is typical
    (``default_engine()``), but apps may build isolated engines (tests do).
    """

    def __init__(self, *, scheduler: Union[str, Scheduler] = "fifo",
                 progress_thread: bool = False,
                 progress_interval: float = 2e-4,
                 n_waiters: int = 0,
                 inline_limit: int = 16,
                 wait_poll_interval: float = 5e-4) -> None:
        self.scheduler = make_scheduler(scheduler, inline_limit=inline_limit)
        self.progress = Progress(self.scheduler,
                                 progress_thread=progress_thread,
                                 progress_interval=progress_interval,
                                 n_waiters=n_waiters)
        self._seq = itertools.count()
        self.wait_poll_interval = wait_poll_interval
        self._progress_calls = 0
        self._promise_cr: Optional[ContinuationRequest] = None
        self._promise_cr_lock = threading.Lock()

    @property
    def inline_limit(self) -> int:
        return self.scheduler.inline_limit

    @inline_limit.setter
    def inline_limit(self, value: int) -> None:
        self.scheduler.inline_limit = value

    @property
    def stats(self) -> dict:
        """Merged component counters (kept flat for existing consumers)."""
        out = {"progress_calls": self._progress_calls}
        out.update(self.scheduler.stats)
        out.update(self.progress.stats)
        return out

    # ------------------------------------------------------------------ setup
    def continue_init(self, info: Optional[Union[dict, ContinueInfo]] = None,
                      **kwargs: Any) -> ContinuationRequest:
        """``MPIX_Continue_init`` analogue.

        The CR's info keys are *defaults*: any individual registration may
        override them with per-registration ``ContinueFlags`` (the
        ``flags=`` argument to ``continue_when``/``continue_all``/the
        combinators), so one CR can aggregate continuations with different
        completion semantics.
        """
        if isinstance(info, ContinueInfo):
            cinfo = info
        else:
            cinfo = make_info(info, **kwargs)
        cr = ContinuationRequest(self, cinfo)
        cr.persistent = True  # CRs are persistent-request-like
        return cr

    # ------------------------------------------------------------ registration
    def continue_when(self, op: Completable, cb, cb_data: Any = None,
                      status: Optional[List[Status]] = None,
                      cr: Optional[ContinuationRequest] = None,
                      flags: Optional[ContinueFlags] = None) -> bool:
        """``MPIX_Continue`` analogue. Returns the immediate-completion flag."""
        return self.continue_all([op], cb, cb_data, statuses=status, cr=cr,
                                 flags=flags)

    def continue_all(self, ops: Sequence[Completable], cb, cb_data: Any = None,
                     statuses: Optional[List[Status]] = None,
                     cr: Optional[ContinuationRequest] = None,
                     flags: Optional[ContinueFlags] = None) -> bool:
        """``MPIX_Continueall`` analogue.

        ``statuses``: None (= MPI_STATUSES_IGNORE) or a caller-allocated list
        of length ``len(ops)`` that is written before the callback runs (or
        before return on immediate completion).

        ``flags``: optional per-registration ``ContinueFlags`` (or mapping)
        overriding the CR's ``ContinueInfo`` defaults for this registration
        only — fast-path participation (``enqueue_complete``), routing
        (``poll_only``), inline eligibility (``immediate`` /
        ``defer_complete``), thread policy, statuses ownership
        (``volatile_statuses``), and error policy (``on_error``).
        """
        if cr is None:
            raise ValueError("a ContinuationRequest is required")
        if statuses is not None and len(statuses) != len(ops):
            raise ValueError("statuses list must match ops length")
        policy = resolve(cr.info, make_flags(flags))
        marked = []
        try:
            for op in ops:
                op.mark_attached()
                marked.append(op)
        except BaseException:
            # Registration failed partway: the already-marked prefix must
            # not stay consumed — the caller still owns those handles.
            for op in marked:
                op.release_attachment()
            raise

        # Immediate-completion fast path (resolved per registration):
        # drive each op's probe once.
        if not policy.enqueue_complete and all(op.done() for op in ops):
            if statuses is not None:
                for i, op in enumerate(ops):
                    statuses[i] = op.status
            cr.stats["immediate"] += 1
            return True

        cont = Continuation(cb, cb_data, ops, statuses, cr, policy)
        cont.seqno = next(self._seq)
        # lifecycle edge 1/4: ops posted with a continuation attached. The
        # sampling decision made here sticks for the continuation's whole
        # lifetime (later edges gate on ``t_posted is not None``).
        tr = _obs.TRACE
        if tr is not None and tr.want(cont.seqno):
            cont.t_posted = ts = tr.now()
            tr.evt(_obs_events.CONT_POSTED, cont.seqno, "core", ts=ts,
                   meta=_obs_events.policy_key(policy))
        try:
            cr._register()           # raises on a freed CR
        except BaseException:
            for op in ops:           # nothing installed yet: full rollback
                op.release_attachment()
            raise
        needs_scan = []
        # Callbacks are never invoked from within continue_[all] itself —
        # registration may happen inside an application critical region
        # (paper §3.1) — so inline execution is suppressed while hooks are
        # installed (a ready continuation lands on the scheduler instead),
        # unless this registration opts in with ``immediate=True``.
        with registration_guard():
            for i, op in enumerate(ops):
                if not op.supports_push and op.state.name == "PENDING":
                    needs_scan.append(op)
                # Hooks fire inline for already-complete ops, so mixed
                # immediate/pending groups resolve correctly.
                op.add_ready_hook(cont.hook_for(i))
        if needs_scan:
            hand_to_waiters = (policy.thread == THREAD_ANY
                               and self.progress.has_waiters)
            for op in needs_scan:
                self.progress.watch(op, use_waiter=hand_to_waiters)
        return False

    # ----------------------------------------------- completion combinators
    def continue_any(self, ops: Sequence[Completable], cb, cb_data: Any = None,
                     statuses: Optional[List[Status]] = None,
                     indices: Optional[List[int]] = None,
                     cr: Optional[ContinuationRequest] = None,
                     flags: Optional[ContinueFlags] = None,
                     cancel_losers: bool = False) -> bool:
        """First-of-n: the callback fires when ANY one op completes
        (``MPI_Testany`` analogue). See ``continue_some`` for the loser
        contract and the ``statuses``/``indices`` reporting."""
        return self.continue_some(ops, 1, cb, cb_data, statuses=statuses,
                                  indices=indices, cr=cr, flags=flags,
                                  cancel_losers=cancel_losers)

    def continue_some(self, ops: Sequence[Completable], k: int, cb,
                      cb_data: Any = None,
                      statuses: Optional[List[Status]] = None,
                      indices: Optional[List[int]] = None,
                      cr: Optional[ContinuationRequest] = None,
                      flags: Optional[ContinueFlags] = None,
                      cancel_losers: bool = False) -> bool:
        """First-k-of-n (``MPI_Testsome``/``Waitsome`` analogue).

        The callback fires once, when the ``k``-th op completes. Reporting
        mirrors ``MPI_Waitsome``: ``indices`` (caller list, any length) is
        rewritten to the winning op indices in completion order, and
        ``statuses`` (caller list of length ``len(ops)``) gets winner
        positions written — both before the callback runs (or before
        return on immediate completion).

        Losers are detached safely: their handles are released (the caller
        may re-attach or drop them), late completions are ignored (the
        callback can never double-fire), and ``cancel_losers=True``
        additionally best-effort-cancels them.
        """
        if cr is None:
            raise ValueError("a ContinuationRequest is required")
        if statuses is not None and len(statuses) != len(ops):
            raise ValueError("statuses list must match ops length")
        comb = when_some(ops, k, cancel_losers=cancel_losers)

        def _report() -> None:
            if indices is not None:
                indices[:] = comb.indices
            if statuses is not None:
                for i in comb.indices:
                    statuses[i] = comb.op_statuses[i]

        def _bridge(_st, data):
            _report()
            cb(statuses, data)

        try:
            flag = self.continue_when(comb, _bridge, cb_data, cr=cr,
                                      flags=flags)
        except BaseException:
            # the composite consumed the children at construction; a failed
            # registration must hand them back, not just the composite —
            # and the orphaned composite must be neutralized so its
            # installed hooks can't later release/cancel attachments owned
            # by a new registration
            comb.detach()
            for op in ops:
                op.release_attachment()
            raise
        if flag:
            _report()
        return flag

    # ------------------------------------------------------ promise front-end
    def wrap(self, op: Completable,
             cr: Optional[ContinuationRequest] = None,
             flags: Optional[ContinueFlags] = None) -> "Promise":
        """Wrap ``op`` into an awaitable/chainable ``Promise``.

        The returned promise resolves with the op's status payload (rejects
        on error/cancellation), supports ``.then()``/``.catch()``
        chaining and ``.cancel()``, and is awaitable from ``async`` code —
        see ``core.promise`` for the asyncio bridge contract. ``cr``
        optionally names the CR to register under (so ``cr.test()`` drives
        poll-mode ops); default is an engine-internal promise CR.
        """
        from repro_torch.core.promise import Promise
        return Promise.of(self, op, cr=cr, flags=flags)

    @property
    def promise_cr(self) -> ContinuationRequest:
        """Engine-internal CR that ``wrap``/Promise registrations default
        to; ``thread=any`` so internal progress/waiter threads may resolve
        promises (resolution is engine-owned code, always safe)."""
        with self._promise_cr_lock:
            if self._promise_cr is None:
                self._promise_cr = self.continue_init(thread=THREAD_ANY)
            return self._promise_cr

    # -------------------------------------------------------------- progress
    def tick(self) -> None:
        """Generic progress: discover + run eligible ready continuations.

        The analogue of "an application thread called into MPI".
        """
        self._progress_calls += 1
        self.progress.scan()
        self.scheduler.drain()

    def enter(self) -> None:
        """Lightweight entry hook: run eligible ready continuations inline.

        Transport (and other substrates) call this on every operation — the
        analogue of "continuations may be invoked as soon as any thread
        calls into MPI" (paper §3) — without paying for a full poll scan.
        """
        self.scheduler.drain(limit=self.scheduler.inline_limit, inline=True)

    def _progress_for_test(self, cr: ContinuationRequest) -> None:
        """Progress driven by ``cr.test()``: bounded by the CR's max_poll.

        Routing is per registration now, so a single CR may hold both
        poll_only continuations (private queue, runnable only here) and
        scheduler-routed ones — drain both under one shared budget.
        """
        self._progress_calls += 1
        self.progress.scan()
        budget = cr.info.max_poll
        ran = self.scheduler.drain_cr_queue(cr, budget)
        remaining = -1 if budget < 0 else max(0, budget - ran)
        # Other CRs' callbacks still run (we are an application thread
        # inside the engine); this CR's scheduler-routed ones are capped
        # by whatever budget the private queue left over.
        self.scheduler.drain(for_cr=cr, cr_limit=remaining)

    # ------------------------------------------------ back-compat delegates
    # Pre-split internal entry points; substrate code now uses the
    # components directly, but external callers may still poke these.
    def _enqueue_ready(self, cont: Continuation) -> None:
        self.scheduler.submit(cont)

    def _drain_ready(self, limit: int = -1, inline: bool = False,
                     for_cr: Optional[ContinuationRequest] = None,
                     cr_limit: int = -1) -> int:
        return self.scheduler.drain(limit=limit, inline=inline,
                                    for_cr=for_cr, cr_limit=cr_limit)

    def _scan_polls(self) -> None:
        self.progress.scan()

    # -------------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        self.progress.shutdown()

    def register_internal_thread(self) -> None:
        """Mark the calling thread as engine-internal (thread=any gating)."""
        self.scheduler.register_internal_thread()


_default_engine: Optional[Engine] = None
_default_lock = threading.Lock()


def default_engine() -> Engine:
    global _default_engine
    with _default_lock:
        if _default_engine is None:
            _default_engine = Engine()
        return _default_engine


def reset_default_engine() -> None:
    global _default_engine
    with _default_lock:
        if _default_engine is not None:
            _default_engine.shutdown()
        _default_engine = None

"""Completable operations — what continuations can be attached to.

In MPI the unit of asynchrony is the request; in a PyTorch framework it is
anything that completes out-of-line with the control thread:

* ``TensorOp``    — device work queued on a CUDA stream; complete when the
                    event recorded after it has fired (``Event.query()``).
* ``HostTaskOp``  — a ``concurrent.futures.Future`` (checkpoint shard writes,
                    data-pipeline fills, metric fetches). Push-notified.
* ``TimerOp``     — completes at a deadline (heartbeat/straggler timeouts).
* ``PredicateOp`` — completes when a user predicate flips true.
* ``MessageOp``   — transport send/recv handles (see ``transport.py``).
* ``ContinuationRequest`` — CRs are completable themselves (paper §3.2:
  a continuation may be attached to a CR and registered with another CR).
* ``CombinedOp``  — a composite over child ops built by the combinators
  ``when_all`` / ``when_any`` / ``when_some``: completes when k of n
  children have completed, detaching (optionally cancelling) the losers.

Ops follow the paper's ownership rule: attaching a continuation *consumes*
the handle (at most one continuation per op; re-attach only for persistent
ops after restart). Combinators consume their children the same way; the
losers of a ``when_any``/``when_some`` get their handles released back to
the caller when the combinator fires.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.status import OneShotLatch, OpState, Status

ReadyHook = Callable[["Completable", Status], None]


class Completable:
    """Base class for asynchronous operations.

    Subclasses either support *polling* (override ``_poll``) or *push*
    notification (call ``_complete`` from wherever the work finishes), or
    both. The continuation engine uses push hooks when available and falls
    back to polling scans during progress calls — mirroring an MPI library
    discovering completions inside any MPI call.
    """

    #: persistent ops may be restarted and re-attached (MPI persistent reqs)
    persistent: bool = False

    def __init__(self) -> None:
        self._latch = OneShotLatch()
        self._state = OpState.PENDING
        self._status = Status()
        self._hooks: list[ReadyHook] = []
        self._hook_lock = threading.Lock()
        self._attached = False

    # -- completion publishing ------------------------------------------------
    def _complete(self, status: Optional[Status] = None,
                  state: OpState = OpState.COMPLETE) -> bool:
        """Publish completion exactly once; fire hooks on the caller thread."""
        if not self._latch.fire():
            return False
        if status is not None:
            self._status = status
        self._state = state
        if state == OpState.CANCELLED:
            self._status.cancelled = True
        with self._hook_lock:
            hooks, self._hooks = list(self._hooks), []
        for hook in hooks:
            hook(self, self._status)
        return True

    # -- probing ----------------------------------------------------------------
    def _poll(self) -> bool:
        """Subclass probe: return True when the underlying work is done.

        Only called while PENDING; must be cheap and non-blocking.
        """
        return False

    def done(self) -> bool:
        """Non-blocking completion test (drives poll-mode ops forward)."""
        if self._state is not OpState.PENDING:
            return True
        if self._poll():
            self._complete(self._make_status())
            return True
        return False

    def _make_status(self) -> Status:
        return self._status

    # -- introspection ---------------------------------------------------------
    @property
    def state(self) -> OpState:
        return self._state

    @property
    def status(self) -> Status:
        return self._status

    @property
    def supports_push(self) -> bool:
        """True if completion will arrive via ``_complete`` without polling."""
        return False

    # -- hooks ------------------------------------------------------------------
    def add_ready_hook(self, hook: ReadyHook) -> None:
        """Run ``hook`` on completion; immediately if already complete."""
        run_now = False
        with self._hook_lock:
            if self._state is OpState.PENDING and not self._latch.fired:
                self._hooks.append(hook)
            else:
                run_now = True
        if run_now:
            hook(self, self._status)

    # -- cancellation ------------------------------------------------------------
    def cancel(self) -> bool:
        """Best-effort cancel; True if the op transitioned to CANCELLED."""
        return self._complete(Status(cancelled=True), OpState.CANCELLED)

    # -- attachment bookkeeping ---------------------------------------------------
    def mark_attached(self) -> None:
        if self._attached and not self.persistent:
            raise RuntimeError(
                "operation already has a continuation attached; non-persistent "
                "handles are consumed on attach (paper §2.2)")
        self._attached = True

    def release_attachment(self) -> None:
        self._attached = False


class TensorOp(Completable):
    """Completion of the device work queued so far on the current stream.

    Construction records a ``torch.cuda.Event`` on the current stream of
    ``tensor``'s device, so the op completes once everything queued before
    it — the step that produced ``tensor`` and any copy started right after
    it — has run. Poll-mode: ``_poll`` is ``event.query()``, which never
    blocks; ``block`` (waiter threads) is ``event.synchronize()``. Work on a
    CPU tensor ran synchronously, so such an op is complete at once.

    ``PENDING_AT_FIRST_POLL`` counts ops still incomplete when first
    polled. If it stays 0 over a serve run, the host waited on every step
    before it polled (a hidden sync in the loop).
    """

    PENDING_AT_FIRST_POLL = 0

    def __init__(self, tensor: Any, payload: Any = None) -> None:
        super().__init__()
        self._status.payload = tensor if payload is None else payload
        self._event = None
        self._polled = False
        if getattr(tensor, "is_cuda", False):
            import torch
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))

    def _poll(self) -> bool:
        # several threads may poll one op (the engine's scan and the
        # transport's release of a held message): read the event once
        event = self._event
        if event is None:
            return True
        ready = event.query()
        if not self._polled:
            self._polled = True
            if not ready:
                TensorOp.PENDING_AT_FIRST_POLL += 1
        if ready:
            self._event = None
        return ready

    def block(self) -> None:
        """Blocking wait used by waiter threads (push emulation)."""
        event = self._event
        if event is not None:
            event.synchronize()
            self._event = None
        self.done()


class HostTaskOp(Completable):
    """Completion of a ``concurrent.futures.Future`` — push-notified."""

    def __init__(self, future: Future) -> None:
        super().__init__()
        self._future = future
        future.add_done_callback(self._on_done)

    @property
    def supports_push(self) -> bool:
        return True

    def _on_done(self, fut: Future) -> None:
        if fut.cancelled():
            self._complete(Status(cancelled=True), OpState.CANCELLED)
            return
        err = fut.exception()
        if err is not None:
            self._complete(Status(error=err), OpState.FAILED)
        else:
            self._complete(Status(payload=fut.result()))

    def _poll(self) -> bool:  # completion arrives via _on_done
        return self._future.done()

    def cancel(self) -> bool:
        self._future.cancel()  # _on_done publishes the transition
        return self._state is OpState.CANCELLED


class TimerOp(Completable):
    """Completes once ``deadline`` (monotonic seconds) has passed."""

    def __init__(self, delay_s: float) -> None:
        super().__init__()
        self.deadline = time.monotonic() + delay_s

    def _poll(self) -> bool:
        return time.monotonic() >= self.deadline


class PredicateOp(Completable):
    """Completes when a user-supplied predicate returns True."""

    def __init__(self, predicate: Callable[[], bool], payload: Any = None) -> None:
        super().__init__()
        self._predicate = predicate
        self._status.payload = payload

    def _poll(self) -> bool:
        return bool(self._predicate())


# --------------------------------------------------------------- combinators
class CombinedOp(Completable):
    """Composite op: completes when ``k`` of ``n`` child ops have completed.

    Construction *consumes* the children (ownership rule). When the k-th
    child completes ("the win"):

    * ``indices`` holds the winning child indices in completion order and
      ``op_statuses[i]`` the winners' statuses (loser slots stay ``None``);
    * every loser's handle is released back to the caller (and best-effort
      cancelled when ``cancel_losers=True``);
    * late loser completions are ignored — the composite can never fire
      twice.

    The composite's own status: ``payload`` shape follows ``mode`` —
    ``"all"`` gives the child-ordered payload list, ``"any"`` the single
    winner's payload, ``"some"`` ``(index, payload)`` pairs in completion
    order. The helpers pin their mode (so ``when_any([op])`` still yields
    the bare winner payload at ``n == 1``); a direct ``CombinedOp``
    construction infers ``all``/``any``/``some`` from ``k`` vs ``n``. The
    first winner error (or cancellation) propagates, so a failed child
    rejects a promise chained on the composite.

    An empty group with ``k == 0`` (``when_all([])``) completes vacuously
    at construction with an empty payload — mirroring
    ``continue_all([], ...)``'s immediate-completion contract.
    """

    def __init__(self, ops: Sequence["Completable"], k: int, *,
                 cancel_losers: bool = False,
                 mode: Optional[str] = None) -> None:
        super().__init__()
        n = len(ops)
        if n == 0:
            if k != 0:
                raise ValueError(f"need k == 0 for an empty group, got {k}")
        elif not 1 <= k <= n:
            raise ValueError(f"need 1 <= k <= {n} ops, got k={k}")
        if mode is None:
            mode = "all" if k == n else "any" if k == 1 else "some"
        if mode not in ("all", "any", "some"):
            raise ValueError(f"unknown combinator mode {mode!r}")
        self._mode = mode
        self._ops = list(ops)
        self._k = k
        self._cancel_losers = cancel_losers
        self._comb_lock = threading.Lock()
        self._won = False
        self.indices: list[int] = []
        self.op_statuses: list[Optional[Status]] = [None] * n
        marked = []
        try:
            for op in self._ops:
                op.mark_attached()
                marked.append(op)
        except BaseException:
            # same rollback contract as Engine.continue_all: a failed
            # construction must not leave the prefix consumed
            for op in marked:
                op.release_attachment()
            raise
        if n == 0:
            self._won = True             # vacuous completion
            self._complete(Status(payload=[]))
            return
        for i, op in enumerate(self._ops):
            op.add_ready_hook(self._child_hook(i))

    def _child_hook(self, index: int):
        def _hook(op: "Completable", status: Status, _i: int = index) -> None:
            self._child_done(_i, status)
        return _hook

    def _child_done(self, i: int, status: Status) -> None:
        with self._comb_lock:
            if self._won:
                return                 # late loser — ignored
            self.op_statuses[i] = status
            self.indices.append(i)
            if len(self.indices) < self._k:
                return
            self._won = True
        self._finish()

    def _finish(self) -> None:
        losers = [op for j, op in enumerate(self._ops)
                  if self.op_statuses[j] is None]
        for op in losers:
            op.release_attachment()
            if self._cancel_losers:
                op.cancel()            # their hooks see _won and no-op
        won = [self.op_statuses[i] for i in self.indices]
        error = next((s.error for s in won if s.error is not None), None)
        cancelled = any(s.cancelled for s in won)
        if self._mode == "all":
            payload = [s.payload for s in self.op_statuses]
        elif self._mode == "any":
            payload = won[0].payload
        else:                             # "some"
            payload = [(i, self.op_statuses[i].payload) for i in self.indices]
        state = (OpState.FAILED if error is not None
                 else OpState.CANCELLED if cancelled else OpState.COMPLETE)
        self._complete(Status(error=error, cancelled=cancelled,
                              payload=payload), state)

    @property
    def supports_push(self) -> bool:
        return all(op.supports_push for op in self._ops)

    def _poll(self) -> bool:
        # Drive pending poll-mode children; completion happens through the
        # child hooks (idempotent against the race with a push child).
        for op in self._ops:
            if self._won:
                break
            if op.state is OpState.PENDING:
                op.done()
        return self._won

    def cancel(self) -> bool:
        with self._comb_lock:
            if self._won:
                return False
            self._won = True           # block child hooks from firing us
        for j, op in enumerate(self._ops):
            if self.op_statuses[j] is None:
                op.release_attachment()
                op.cancel()
        return self._complete(Status(cancelled=True), OpState.CANCELLED)

    def detach(self) -> None:
        """Neutralize the composite: ignore every future child completion.

        Used by registration rollback — ``Completable`` has no hook
        removal, so after the children are handed back to the caller the
        orphaned composite must never release/cancel them out from under
        a later registration. The composite itself never completes.
        """
        with self._comb_lock:
            self._won = True


def when_all(ops: Sequence["Completable"]) -> CombinedOp:
    """Composite completing when ALL of ``ops`` complete (payload = child
    payload list in op order; an empty group completes vacuously)."""
    return CombinedOp(ops, len(ops), mode="all")


def when_any(ops: Sequence["Completable"], *,
             cancel_losers: bool = False) -> CombinedOp:
    """Composite completing when ANY child completes (payload = winner's
    payload, regardless of group size; ``.indices[0]`` names the winner)."""
    return CombinedOp(ops, 1, cancel_losers=cancel_losers, mode="any")


def when_some(ops: Sequence["Completable"], k: int, *,
              cancel_losers: bool = False) -> CombinedOp:
    """Composite completing when ``k`` children have completed
    (``MPI_Waitsome`` analogue; payload = ``(index, payload)`` pairs in
    completion order — see ``CombinedOp`` for indices/statuses)."""
    return CombinedOp(ops, k, cancel_losers=cancel_losers, mode="some")

"""Awaitable promise front-end over the continuation engine.

The raw engine surface is ``cb(statuses, cb_data)`` — exactly right for
runtime-internal completion plumbing, and exactly wrong for slotting under
higher-level asynchronous programming models (the fibers-vs-pthreads
companion paper's point: continuations should *compose into* whatever APM
the application uses). ``Promise`` is that bridge:

* ``engine.wrap(op)`` returns a ``Promise`` that resolves with the op's
  status payload (rejects on error; rejects ``PromiseCancelled`` on
  cancellation).
* ``.then(fn)`` / ``.catch(fn)`` chain: handlers run when the promise
  settles (immediately if already settled, on the settling thread
  otherwise); a handler returning a ``Promise`` or a ``Completable`` is
  adopted, so continuation pipelines read top-to-bottom.
* ``.cancel()`` propagates to the underlying operation; the rejection then
  flows through the same resolution path as any other completion.
* ``await promise`` works from any running asyncio event loop. Wakeups are
  loop-safe: a resolution arriving from a foreign thread is delivered via
  ``loop.call_soon_threadsafe``; a resolution on the loop thread itself
  sets the future directly (no extra loop hop — the awaitable-bridge
  latency the ``core.api.*`` bench gates). While an awaited promise is
  unsettled the bridge keeps the engine progressing from the loop
  (``call_later`` ticks), so poll-mode ops (``TensorOp``, ``TimerOp``)
  resolve without any thread ever blocking in the engine.

Resolution itself is engine-owned code (record value, wake waiters, run
chained handlers), registered with per-registration flags
``enqueue_complete=True`` (an already-complete op still resolves through
the machinery) and ``immediate=True`` (safe to run inline even inside
``continue_when``).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.core.completable import Completable, when_all, when_any
from repro_torch.core.flags import ContinueFlags, merge_flags
from repro_torch.core.status import Status

PENDING = "pending"
FULFILLED = "fulfilled"
REJECTED = "rejected"

#: flags every promise-resolution registration uses (see module docstring)
_RESOLVE_FLAGS = ContinueFlags(enqueue_complete=True, immediate=True)

# Per-thread cache of the running event loop: ``asyncio.get_running_loop``
# is a surprisingly expensive call on some OS kernels (~20us), and
# the await bridge needs the loop on every ``__await__``. A cached loop is
# valid while it is still running on this thread (two loops cannot run on
# one thread, and a finished ``asyncio.run`` leaves ``is_running`` False).
_BRIDGE_TLS = threading.local()


def _running_loop():
    loop = getattr(_BRIDGE_TLS, "loop", None)
    if loop is None or not loop.is_running():
        import asyncio
        loop = asyncio.get_running_loop()
        _BRIDGE_TLS.loop = loop
    return loop


class PromiseCancelled(Exception):
    """The promise's underlying operation was cancelled."""


class Promise:
    """A one-shot settled-exactly-once value with chaining and await."""

    def __init__(self, engine=None, op: Optional[Completable] = None) -> None:
        self._engine = engine
        self._op = op                  # cancellation target (may be None)
        self._lock = threading.Lock()
        self._state = PENDING
        self._value: Any = None        # fulfil value or rejection error
        self._settle_cbs: List[Callable[[str, Any], None]] = []
        # blocking waiters are rare (await/then don't block): the
        # condition is created lazily by result() — an Event here would
        # put a kernel wakeup on every settle
        self._waiter: Optional[threading.Condition] = None

    # ------------------------------------------------------------ construction
    @classmethod
    def of(cls, engine, op: Completable, cr=None,
           flags: Optional[ContinueFlags] = None) -> "Promise":
        """Promise over one operation (``engine.wrap`` calls this).

        ``flags`` layers extra per-registration flags (e.g. ``thread``)
        over the promise-resolution defaults.
        """
        p = cls(engine, op)
        use_cr = cr if cr is not None else engine.promise_cr

        def _resolve(_statuses, _data, _p=p, _op=op, _settle=p._settle):
            st = _op._status
            if st.error is not None:
                _settle(REJECTED, st.error)
            elif st.cancelled:
                _settle(REJECTED, PromiseCancelled())
            else:
                _settle(FULFILLED, st.payload)

        engine.continue_when(op, _resolve, cr=use_cr,
                             flags=merge_flags(_RESOLVE_FLAGS, flags))
        return p

    @classmethod
    def all_of(cls, engine, ops: Sequence[Completable], cr=None) -> "Promise":
        """Promise over ``when_all(ops)`` — fulfils with the payload list."""
        return cls.of(engine, when_all(ops), cr=cr)

    @classmethod
    def any_of(cls, engine, ops: Sequence[Completable], *, cr=None,
               cancel_losers: bool = False) -> "Promise":
        """Promise over ``when_any(ops)`` — fulfils with the winner payload."""
        return cls.of(engine, when_any(ops, cancel_losers=cancel_losers),
                      cr=cr)

    @classmethod
    def deferred(cls, engine=None) -> "Promise":
        """Externally-settled promise: call ``.resolve()``/``.reject()``."""
        return cls(engine, None)

    # ------------------------------------------------------------- settling
    def _settle(self, state: str, value: Any) -> bool:
        lock = self._lock
        lock.acquire()
        if self._state is not PENDING:
            lock.release()
            return False
        self._value = value
        self._state = state              # written last: lock-free readers
        cbs = self._settle_cbs
        self._settle_cbs = ()
        if self._waiter is not None:
            self._waiter.notify_all()
        lock.release()
        for cb in cbs:
            try:
                cb(state, value)
            except Exception:
                # settle callbacks are delivery plumbing (asyncio futures,
                # then-children): one broken consumer (e.g. a closed event
                # loop) must not starve the others or blow up the engine
                # thread that settled the promise
                pass
        return True

    def _fulfill(self, value: Any) -> bool:
        return self._settle(FULFILLED, value)

    def _reject(self, error: BaseException) -> bool:
        return self._settle(REJECTED, error)

    # public aliases for deferred promises (external producers)
    resolve = _fulfill
    reject = _reject

    def _on_settle(self, cb: Callable[[str, Any], None]) -> None:
        """Run ``cb(state, value)`` at settle; immediately if settled."""
        with self._lock:
            if self._state is PENDING:
                self._settle_cbs.append(cb)
                return
            state, value = self._state, self._value
        cb(state, value)

    # ------------------------------------------------------------ inspection
    @property
    def state(self) -> str:
        return self._state

    def done(self) -> bool:
        return self._state is not PENDING

    # -------------------------------------------------------------- chaining
    def then(self, on_fulfilled: Optional[Callable[[Any], Any]] = None,
             on_rejected: Optional[Callable[[BaseException], Any]] = None
             ) -> "Promise":
        """Chain: returns a promise settled from the handler's outcome.

        The matching handler runs on the settling thread (immediately, if
        this promise already settled). A handler returning a ``Promise``
        or ``Completable`` is adopted; a raise rejects the child. A
        missing handler passes fulfilment/rejection through unchanged.
        """
        child = Promise(self._engine, self._op)  # cancel() reaches the source

        def _settle(state: str, value: Any) -> None:
            handler = on_fulfilled if state is FULFILLED else on_rejected
            if handler is None:
                if state is FULFILLED:
                    child._fulfill(value)
                else:
                    child._reject(value)
                return
            try:
                out = handler(value)
            except BaseException as exc:
                child._reject(exc)
                return
            child._adopt(out)

        self._on_settle(_settle)
        return child

    def catch(self, on_rejected: Callable[[BaseException], Any]) -> "Promise":
        return self.then(None, on_rejected)

    def _adopt(self, out: Any) -> None:
        """Settle from a handler result (promise/op chaining)."""
        if isinstance(out, Promise):
            self._op = out._op if out._op is not None else self._op
            out._on_settle(
                lambda s, v: self._fulfill(v) if s is FULFILLED
                else self._reject(v))
        elif isinstance(out, Completable) and self._engine is not None:
            self._adopt(Promise.of(self._engine, out))
        else:
            self._fulfill(out)

    # ---------------------------------------------------------- cancellation
    def cancel(self) -> bool:
        """Best-effort cancel of the underlying operation.

        The rejection (``PromiseCancelled``) arrives through the normal
        resolution path, so chained children settle consistently. A
        deferred promise (no underlying op) rejects directly.
        """
        if self._op is not None:
            return self._op.cancel()
        return self._reject(PromiseCancelled())

    # ------------------------------------------------------------- sync wait
    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until settled, driving engine progress; return the value
        or raise the rejection error. Not for use inside callbacks."""
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        interval = (self._engine.wait_poll_interval
                    if self._engine is not None else 5e-4)
        while self._state is PENDING:
            if self._engine is not None:
                self._engine.tick()
            if deadline is not None and time.monotonic() >= deadline:
                if self._state is PENDING:
                    raise TimeoutError("promise unsettled after timeout")
                break
            with self._lock:
                if self._state is not PENDING:
                    break
                if self._waiter is None:
                    self._waiter = threading.Condition(self._lock)
                self._waiter.wait(interval)
        if self._state is REJECTED:
            raise self._value
        return self._value

    # ---------------------------------------------------------- asyncio bridge
    def __await__(self):
        if self._state is not PENDING:       # settled: no future, no loop
            if self._state is REJECTED:
                raise self._value
            return _settled_iter(self._value)
        loop = _running_loop()
        fut = loop.create_future()
        loop_thread = threading.get_ident()

        def _deliver(state: str, value: Any) -> None:
            def _set() -> None:
                if fut.cancelled():
                    return
                if state is FULFILLED:
                    fut.set_result(value)
                else:
                    fut.set_exception(value)

            if threading.get_ident() == loop_thread:
                _set()                       # loop thread: no extra hop
            else:
                loop.call_soon_threadsafe(_set)

        self._on_settle(_deliver)
        self._schedule_progress(loop)
        return fut.__await__()

    def _schedule_progress(self, loop) -> None:
        """Keep the engine progressing from the loop while unsettled, so
        poll-mode ops resolve without a dedicated progress thread.

        One progress chain per (engine, loop) — N concurrent awaits share a
        single ``call_later`` tick chain instead of scheduling N redundant
        full progress scans per interval. The registry is thread-local
        (the loop is bound to this thread); the chain retires itself when
        its watch set drains, and a stale entry from a finished loop is
        simply replaced.
        """
        eng = self._engine
        if eng is None or self._state is not PENDING:
            return
        drivers = getattr(_BRIDGE_TLS, "drivers", None)
        if drivers is None:
            drivers = _BRIDGE_TLS.drivers = {}
        # Purge entries from loops that are no longer running on this
        # thread (a chain's final retirement tick is often scheduled after
        # asyncio.run() already closed the loop): only one loop runs per
        # thread, so anything not running is dead — without this the dict
        # pins finished loops/engines for the thread's lifetime and id()
        # reuse could alias a dead entry to a new engine.
        for stale in [k for k, (lp, _w) in drivers.items()
                      if lp is not loop and not lp.is_running()]:
            del drivers[stale]
        key = id(eng)
        entry = drivers.get(key)
        if entry is not None and entry[0] is loop:
            entry[1].add(self)           # chain already running: join it
            return
        watch = {self}
        drivers[key] = (loop, watch)
        interval = max(eng.wait_poll_interval, 1e-4)

        def _poll() -> None:
            live = [p for p in watch if p._state is PENDING]
            watch.clear()
            watch.update(live)
            if not live:
                if drivers.get(key) is not None \
                        and drivers[key][0] is loop:
                    del drivers[key]
                return
            eng.tick()
            loop.call_later(interval, _poll)

        loop.call_soon(_poll)


def _settled_iter(value):
    """Iterator for awaiting an already-settled promise: returns the value
    to ``yield from`` without ever yielding to the event loop."""
    return value
    yield  # pragma: no cover — generator marker


class Signal:
    """Multi-shot settle support: a re-armable completion signal.

    A ``Promise`` settles exactly once — right for one operation, wrong
    for a *stream* of completions (per-token delivery, repeated sweeps).
    ``Signal`` chains one-shot promises into a multi-shot gate:

    * ``wait()`` returns the **current generation's** promise. Await it
      (loop-safe, same asyncio bridge as any promise) or chain on it.
    * ``set(value)`` fulfils the current generation and atomically arms a
      fresh one, so the next ``wait()`` observes only *later* sets.

    The lost-wakeup-free consumer pattern is **arm → check → await**::

        while True:
            p = signal.wait()          # arm FIRST
            if <state check finds work or a terminal condition>:
                ...consume/return...   # p is simply dropped
                continue
            await p                    # fulfilled by any set() after wait()

    Any ``set()`` that raced between the arm and the check fulfilled the
    armed promise, so the await cannot sleep through it. A ``set()``
    with **no armed waiter is a cheap no-op** (no promise churn on the
    producer's hot path — a decode loop signalling per token pays only a
    flag check while nobody streams asynchronously); consequently the
    signal is a *wakeup* gate, not a value channel — consumers must read
    the actual state in the check step, exactly as the pattern above
    does. Producers call ``set()`` *after* publishing state; ``set()``
    never blocks, so a completion continuation can signal safely.
    """

    def __init__(self, engine=None) -> None:
        self._engine = engine
        self._lock = threading.Lock()
        self._current = Promise(engine, None)
        self._armed = False
        self.fired = 0        # total set() calls (informational)

    def wait(self) -> Promise:
        """Arm: the promise fulfilled by the next ``set()``."""
        with self._lock:
            self._armed = True
            return self._current

    def set(self, value: Any = None) -> None:
        """Fulfil the armed generation (if any) and re-arm a fresh one."""
        with self._lock:
            self.fired += 1
            if not self._armed:
                return                 # nobody waiting: skip the churn
            self._armed = False
            settled, self._current = self._current, Promise(self._engine,
                                                            None)
        settled._fulfill(value)


def wrap(engine, op: Completable, cr=None) -> Promise:
    """Module-level alias of ``engine.wrap``."""
    return Promise.of(engine, op, cr=cr)

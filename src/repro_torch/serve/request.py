"""Serving request lifecycle — each request is itself a ``Completable``.

A ``Request`` moves through::

    QUEUED ──admit──▶ PREFILLING ──first token──▶ DECODING ──retire──▶ FINISHED
       │                                              │           ▲
       │                                              ├─deadline─▶ EXPIRED
       └────────────────────────cancel────────────────┴──▶ CANCELLED

Because a ``Request`` is a ``Completable``, callers interact with it
exactly like any other operation in this runtime: attach a continuation
(``engine.continue_when(request, on_done, cr=cr)``), group several into a
``continue_all``, or block with ``request.wait()``. Completion status
carries the generated token ids as payload.

Knobs are a structured ``GenerationConfig`` (``serve.config``), validated
once at construction. The legacy loose kwargs (``max_new_tokens=``,
``speculate=``) still work as deprecated shims; ``Request(prompt, n)``
with an int stays as the canonical shorthand for
``GenerationConfig(max_tokens=n)``.

**Token delivery.** The engine pushes budget-tracking device scalars at
dispatch (``push_device_token``) and *delivers* host ints from the
step-completion continuations (``deliver``) — where the paper's
callback-driven lifecycle guarantees the arrays are materialized, so
``int()`` never blocks. Delivery owns stop-sequence matching (with
holdback: a token that could still extend into a stop match is withheld
until it can't, so streamed and retirement-time token lists are identical
and the excluded stop sequence is never observable) and feeds the
attached ``TokenStream``, if any. ``cancel()`` closes the stream under
the same lock delivery takes: once ``cancel()`` returns, no further token
can be delivered — even one produced by a step already in flight.

Timing fields feed the serving metrics (benchmarks and tests): arrival,
admission, first-token (TTFT), and finish timestamps.
"""
from __future__ import annotations

import enum
import itertools
import threading
import time
import warnings
from typing import Any, List, Optional, Sequence, Union

from repro_torch.core.completable import Completable
from repro_torch.core.status import OpState, Status
from repro_torch.obs import events as _obs_events
from repro_torch.obs import tracer as _obs
from repro_torch.serve.config import DeadlineExceeded, GenerationConfig

_req_ids = itertools.count()
_UNSET = object()


class RequestState(enum.Enum):
    QUEUED = "queued"            # submitted, not yet admitted to a slot
    PREFILLING = "prefilling"    # prompt being processed
    DECODING = "decoding"        # in a decode slot, generating
    FINISHED = "finished"        # all tokens generated (op COMPLETE)
    CANCELLED = "cancelled"      # cancelled before finishing
    EXPIRED = "expired"          # QoS deadline passed before finishing


_TERMINAL = (RequestState.FINISHED, RequestState.CANCELLED,
             RequestState.EXPIRED)


class Request(Completable):
    """One generation request: prompt in, ``config.max_tokens`` greedy
    tokens out (fewer if a stop sequence or the deadline hits first).

    ``prompt`` is a 1-D int sequence (list/numpy). ``config`` is a
    ``GenerationConfig`` or an int shorthand for ``max_tokens``. Generated
    token ids accumulate in ``tokens`` (host ints, final at retirement).
    """

    def __init__(self, prompt: Any,
                 config: Union[None, int, GenerationConfig] = None,
                 *, max_new_tokens: Optional[int] = None,
                 speculate: Any = _UNSET,
                 arrival_time: Optional[float] = None) -> None:
        super().__init__()
        if max_new_tokens is not None:
            if config is not None:
                raise ValueError(
                    "pass either config/max_tokens or the deprecated "
                    "max_new_tokens kwarg, not both")
            warnings.warn(
                "Request(max_new_tokens=...) is deprecated; pass "
                "Request(prompt, n) or GenerationConfig(max_tokens=n)",
                DeprecationWarning, stacklevel=2)
            config = int(max_new_tokens)
        if config is None:
            raise ValueError("Request needs a GenerationConfig (or an int "
                             "max_tokens shorthand)")
        if isinstance(config, GenerationConfig):
            cfg = config
        else:
            cfg = GenerationConfig(max_tokens=int(config))
        if speculate is not _UNSET:
            warnings.warn(
                "Request(speculate=...) is deprecated; set "
                "GenerationConfig(speculate=...)",
                DeprecationWarning, stacklevel=2)
            cfg = cfg.merged(
                speculate=None if speculate is None else int(speculate))
        self.config = cfg
        self.req_id = next(_req_ids)
        self.prompt = prompt
        self.draft_tokens_proposed = 0
        self.draft_tokens_accepted = 0
        self.req_state = RequestState.QUEUED
        self.tokens: List[int] = []
        # paged serving: KV pages held (engine-owned; emptied at eviction)
        # and how many prompt tokens were satisfied from the prefix cache
        self.page_ids: List[int] = []
        self.shared_prefix_tokens = 0
        # device-side per-step token refs: budget bookkeeping at dispatch;
        # only materialized at retirement if delivery never ran (legacy
        # direct-push path — the engine always delivers)
        self._device_tokens: List[Any] = []
        # host-side delivery (step-completion continuations): committed
        # tokens, stop-match holdback tail, and the attached stream.
        # RLock: cancel()/retire() fire completion hooks while holding it,
        # and a hook may drain a step continuation that re-enters deliver.
        self._deliver_lock = threading.RLock()
        self._out: List[int] = []
        self._hold: List[int] = []
        # per-token delivery instants (monotonic), 1:1 with committed
        # tokens: stamped where delivery publishes to the stream, so the
        # bench runner reads inter-token latencies without per-consumer
        # timing threads. Tokens committed by one step share a stamp.
        self.token_times: List[float] = []
        self._delivered_any = False
        self._stop_hit = False
        self._stream: Optional[Any] = None    # serve.api.TokenStream
        self._finished_evt = threading.Event()
        # -- timing (monotonic seconds) --
        self.arrival_time = (time.monotonic() if arrival_time is None
                             else arrival_time)
        self.admit_time: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None

    # ------------------------------------------------------------ config view
    @property
    def max_new_tokens(self) -> int:
        return self.config.max_tokens

    @property
    def speculate(self) -> Optional[int]:
        return self.config.speculate

    @property
    def priority(self) -> int:
        return self.config.priority

    @property
    def tenant(self) -> str:
        return self.config.tenant

    @property
    def deadline_time(self) -> Optional[float]:
        """Absolute monotonic deadline (``None`` = no deadline). Derived
        from ``arrival_time`` at read time so load generators that stamp
        arrival late keep a consistent deadline."""
        if self.config.deadline_s is None:
            return None
        return self.arrival_time + self.config.deadline_s

    def past_deadline(self, now: Optional[float] = None) -> bool:
        dt = self.deadline_time
        if dt is None:
            return False
        return (time.monotonic() if now is None else now) >= dt

    # ------------------------------------------------------------- lifecycle
    def on_admitted(self) -> None:
        # guard like on_first_token: a cancel() racing admission must not
        # be resurrected into the decode pipeline
        if self.req_state is RequestState.QUEUED:
            self.req_state = RequestState.PREFILLING
        self.admit_time = time.monotonic()

    def on_requeued(self) -> None:
        """Undo admission (capacity-deferred: back to the queue head).
        A concurrent cancel() must not be resurrected — only an
        in-flight admission is downgraded (the batcher drops CANCELLED
        requests at the next admit)."""
        if self.req_state is RequestState.PREFILLING:
            self.req_state = RequestState.QUEUED
        self.admit_time = None

    def on_first_token(self) -> None:
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
        # the continuation may fire after a concurrent cancel(); a terminal
        # state must never be downgraded back to DECODING
        if self.req_state is RequestState.PREFILLING:
            self.req_state = RequestState.DECODING

    def push_device_token(self, token: Any) -> None:
        """Record one generated token at dispatch (may still be an
        in-flight device scalar; budget bookkeeping only)."""
        self._device_tokens.append(token)

    @property
    def is_terminal(self) -> bool:
        """FINISHED, CANCELLED or EXPIRED — nothing further can happen."""
        return self.req_state in _TERMINAL

    @property
    def generated(self) -> int:
        return len(self._device_tokens)

    @property
    def remaining(self) -> int:
        return self.config.max_tokens - self.generated

    @property
    def delivered(self) -> int:
        """Tokens committed to the output so far (stream-visible; excludes
        stop-sequence holdback). The failover replay offset: a restarted
        request re-generates exactly this many tokens before new ones."""
        with self._deliver_lock:
            return len(self._out)

    # --------------------------------------------------------------- delivery
    def attach_stream(self, stream: Any) -> None:
        """Attach the single ``TokenStream`` receiving per-token delivery.

        Tokens committed before attachment are replayed; a terminal
        request closes the stream immediately with the matching reason.
        """
        with self._deliver_lock:
            if self._stream is not None:
                raise RuntimeError("request already has a stream attached")
            self._stream = stream
            if self._out:
                stream._publish(list(self._out))
            terminal = self.req_state if self.req_state in _TERMINAL \
                else None
        # close outside the lock — _close settles the stream's done
        # promise, which runs user .then() handlers (see retire())
        if terminal is not None:
            stream._close(terminal.value)

    def deliver(self, toks: Sequence[int]) -> Optional[str]:
        """Deliver host tokens from a step-completion continuation.

        Returns ``"stop"`` when a stop sequence completed generation with
        this batch, else ``None``. Tokens arriving after a terminal state
        (or after a stop already hit) are dropped — ``cancel()`` holds the
        same lock, so nothing is delivered after it returns.
        """
        with self._deliver_lock:
            if self.req_state in _TERMINAL or self._stop_hit:
                return None
            self._delivered_any = True
            stops = self.config.stop
            if not stops:
                committed = [int(t) for t in toks]
                self._out.extend(committed)
            else:
                committed = []
                for t in toks:
                    hit = self._hold_token(int(t), committed)
                    if hit:
                        self._stop_hit = True
                        break
            if committed:
                self.token_times.extend(
                    [time.monotonic()] * len(committed))
                tr = _obs.TRACE
                if tr is not None and tr.want(self.req_id):
                    tr.evt(_obs_events.REQ_DELIVER, self.req_id, "serve",
                           meta=len(committed))
                if self._stream is not None:
                    self._stream._publish(committed)
            return "stop" if self._stop_hit else None

    def _hold_token(self, t: int, committed: List[int]) -> bool:
        """Stop-sequence matching with holdback (see module docstring).

        Appends ``t`` to the holdback tail; commits any prefix of the tail
        that can no longer participate in a stop match (into ``_out`` and
        ``committed``). Returns True when the tail completed a stop
        sequence — the matched tokens are discarded (stop sequences are
        excluded from output)."""
        hold = self._hold
        hold.append(t)
        for seq in self.config.stop:
            n = len(seq)
            if len(hold) >= n and tuple(hold[-n:]) == seq:
                front = hold[:-n]      # can no longer match: commit
                self._out.extend(front)
                committed.extend(front)
                self._hold = []
                return True
        # longest suffix of the tail that is a proper prefix of some stop
        # sequence must stay held; everything before it is committed
        keep = 0
        for seq in self.config.stop:
            for k in range(min(len(hold), len(seq) - 1), keep, -1):
                if tuple(hold[-k:]) == seq[:k]:
                    keep = k
                    break
        cut = len(hold) - keep
        if cut:
            front = hold[:cut]
            self._out.extend(front)
            committed.extend(front)
            self._hold = hold[cut:]
        return False

    def rewind_holdback(self) -> int:
        """Failover support: drop the uncommitted stop-matching tail and
        return the committed-token count (the replay offset). A request
        restarted from its prompt regenerates the held-back tokens, which
        then re-enter ``deliver``'s stop matching from a clean state —
        replayed delivery stays identical to the uninterrupted run."""
        with self._deliver_lock:
            self._hold = []
            return len(self._out)

    def _flush_hold(self) -> None:
        """Commit the holdback tail (no stop match can complete anymore)."""
        if self._hold:
            front, self._hold = self._hold, []
            self._out.extend(front)
            self.token_times.extend([time.monotonic()] * len(front))
            if self._stream is not None:
                self._stream._publish(front)

    # ------------------------------------------------------------- completion
    def _trace_finish(self, reason: str) -> None:
        tr = _obs.TRACE
        if tr is not None and tr.want(self.req_id):
            tr.evt(_obs_events.REQ_FINISH, self.req_id, "serve", meta=reason)

    def retire(self) -> bool:
        """Finish the request: finalize tokens, publish completion.
        Returns False (no-op) if the request already reached a terminal
        state (concurrent cancel, expiry, or an earlier stop-retirement).
        """
        with self._deliver_lock:
            if self.req_state in _TERMINAL:
                return False
            if self._delivered_any:
                self._flush_hold()
                self.tokens = list(self._out)
            else:
                # legacy direct-push path (tests drive it): materialize
                self.tokens = [int(t) for t in self._device_tokens]
            self._device_tokens = []
            self.req_state = RequestState.FINISHED
            self.finish_time = time.monotonic()
            self._finished_evt.set()
            stream = self._stream
        # stream close and completion hooks (promise resolutions, user
        # .then() handlers, attached continuations — which may
        # inline-drain unrelated ready continuations) run OUTSIDE the
        # delivery lock: the terminal-state flip above already guarantees
        # delivery atomicity, and holding the lock across code that can
        # touch *other* requests could order locks ABBA
        self._trace_finish("finished")
        if stream is not None:
            stream._close("finished")
        self._complete(Status(payload=self.tokens, count=len(self.tokens)))
        return True

    def cancel(self) -> bool:
        """Cancel a not-yet-finished request (best effort: queued requests
        are dropped by the batcher; in-flight slots are swept at the next
        step boundary). Atomic against delivery: once ``cancel()``
        returns, no token — including one produced by the very step being
        cancelled under — is delivered to the stream or the token list.
        """
        with self._deliver_lock:
            if self.req_state in _TERMINAL:
                return False
            # the state flip is the atomic cutoff: any deliver() serialized
            # after this lock release drops its tokens
            self.req_state = RequestState.CANCELLED
            self.finish_time = time.monotonic()
            self._finished_evt.set()
            stream = self._stream
        # stream close + hooks outside the lock (see retire()); the state
        # check above makes this thread the only one reaching them, and
        # both still run before cancel() returns
        self._trace_finish("cancelled")
        if stream is not None:
            stream._close("cancelled")
        self._complete(Status(cancelled=True), OpState.CANCELLED)
        return True

    def expire(self) -> bool:
        """Deadline passed: fail the request with ``DeadlineExceeded``.

        Called by the batcher (queued past-deadline refusal) and by the
        engine's step-completion continuations (in-slot expiry, in the
        same continuation that releases the request's pages). Partial
        tokens stay readable on ``.tokens`` and ride the exception.
        """
        with self._deliver_lock:
            if self.req_state in _TERMINAL:
                return False
            self._flush_hold()
            self.tokens = list(self._out)
            err = DeadlineExceeded(
                f"request {self.req_id} missed its deadline "
                f"({self.config.deadline_s}s from arrival) with "
                f"{len(self.tokens)}/{self.config.max_tokens} tokens",
                tokens=self.tokens)
            self.req_state = RequestState.EXPIRED
            self.finish_time = time.monotonic()
            self._finished_evt.set()
            stream = self._stream
        # stream close + hooks outside the lock (see retire())
        self._trace_finish("expired")
        if stream is not None:
            stream._close("expired", err)
        self._complete(Status(error=err, payload=self.tokens),
                       OpState.FAILED)
        return True

    # --------------------------------------------------------- completable
    @property
    def supports_push(self) -> bool:
        return True    # retire()/cancel()/expire() publish completion

    def _poll(self) -> bool:
        return self._finished_evt.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block the *caller* until finished (the engine loop never does)."""
        return self._finished_evt.wait(timeout)

    # -------------------------------------------------------------- metrics
    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, from arrival (seconds)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def accept_rate(self) -> Optional[float]:
        """Fraction of proposed draft tokens the verify step accepted
        (None when the request never ran speculatively)."""
        if self.draft_tokens_proposed == 0:
            return None
        return self.draft_tokens_accepted / self.draft_tokens_proposed

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def __repr__(self) -> str:
        return (f"Request(id={self.req_id}, state={self.req_state.value}, "
                f"generated={self.generated}/{self.config.max_tokens})")


def summarize(requests: Sequence[Request]) -> dict:
    """Aggregate serving metrics over finished requests."""
    done = [r for r in requests if r.req_state is RequestState.FINISHED]
    ttfts = sorted(r.ttft for r in done if r.ttft is not None)
    total_tokens = sum(len(r.tokens) for r in done)
    proposed = sum(r.draft_tokens_proposed for r in done)
    accepted = sum(r.draft_tokens_accepted for r in done)
    out = {
        "finished": len(done),
        "total_tokens": total_tokens,
        "ttft_mean": sum(ttfts) / len(ttfts) if ttfts else 0.0,
        "ttft_p50": _percentile(ttfts, 0.50),
        "ttft_p99": _percentile(ttfts, 0.99),
        "draft_tokens_proposed": proposed,
        "draft_tokens_accepted": accepted,
        "accept_rate": accepted / proposed if proposed else 0.0,
    }
    return out


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]

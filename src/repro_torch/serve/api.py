"""Streaming session API — the serving front-end users actually call.

``ServeEngine`` speaks the runtime's native dialect (submit a ``Request``,
get tokens at retirement). This module is the *application-facing*
surface on top of it, built the way the paper says APM front-ends should
be: loosely coupled to the completion-notification engine, with all
concurrency surfaced through continuations rather than polling threads.

::

    client = ServeClient(cfg, params, max_batch=8)
    session = client.session(max_tokens=32, priority=1)

    stream = session.generate(prompt)            # -> TokenStream
    for tok in stream:                           # sync: per-token
        ...
    # or, from async code:
    async for tok in session.generate(prompt):   # asyncio: per-token
        ...
    text = await session.generate(prompt).text() # or just the final text

Delivery path (no polling thread anywhere): each decode-step completion
continuation delivers the newly accepted tokens to the ``Request``
(``Request.deliver``), which publishes them into the attached
``TokenStream``. The stream wakes sync consumers through a condition
variable and async consumers through a ``core.promise.Signal`` — a
re-armable chain of one-shot promises whose loop-safe settle
(``call_soon_threadsafe`` from the decode loop) is the same wakeup
machinery every promise uses. The decode loop never blocks on a
consumer: a consumer that falls more than ``config.stream_buffer``
tokens behind just marks the stream ``lagging`` (per-token wakeup
degrades to catch-up bursts; no token is ever dropped, and the final
token list is identical to retirement-time delivery).

``cancel()`` is atomic against delivery: tokens produced by a step still
in flight when ``cancel()`` returns are never delivered.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterator, List, Optional, Union

from repro_torch.core import Promise, PromiseCancelled, Signal
from repro_torch.obs import events as _obs_events
from repro_torch.obs import tracer as _obs
from repro_torch.serve.config import DeadlineExceeded, GenerationConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.protocol import EngineLike
from repro_torch.serve.request import Request, RequestState


def _default_detokenize(tokens: List[int]) -> str:
    """This repro is token-in/token-out (no tokenizer ships with it);
    the canonical rendering is space-joined token ids. Pass
    ``detokenize=`` to ``ServeClient`` to plug a real one."""
    return " ".join(str(t) for t in tokens)


class TokenStream:
    """Per-token view of one generation — sync iterator *and* async
    iterator, fed by the decode engine's step-completion continuations.

    Single-consumer. Iteration yields token ids as they are accepted and
    ends when the request finishes (budget or stop sequence), is
    cancelled, or misses its deadline — inspect ``reason`` afterwards, or
    use ``tokens()`` / ``text()``, which reject on cancel/expiry.
    """

    def __init__(self, request: Request,
                 detokenize: Optional[Callable[[List[int]], str]] = None
                 ) -> None:
        self.request = request
        self._detokenize = detokenize or _default_detokenize
        self._watermark = request.config.stream_buffer
        self._cond = threading.Condition()
        self._toks: List[int] = []        # everything ever published
        self._yielded = 0                 # consumed by this stream's iterator
        self._reason: Optional[str] = None
        self._lagging = False
        self._signal = Signal()           # async wakeup (multi-shot settle)
        self._done = Promise.deferred()   # settles at close
        self.first_token_time: Optional[float] = None
        request.attach_stream(self)

    # ---------------------------------------------------- engine-facing side
    # Called under the request's delivery lock, from the step-completion
    # continuation (or cancel()/retire()/expire() on their caller's
    # thread). Must never block: state update + wakeup only.
    def _publish(self, toks: List[int]) -> None:
        with self._cond:
            if self._reason is not None:
                return
            if self.first_token_time is None:
                self.first_token_time = time.monotonic()
            self._toks.extend(toks)
            if len(self._toks) - self._yielded > self._watermark:
                # consumer is further behind than the configured buffer:
                # it observes catch-up bursts from here on (sticky flag)
                self._lagging = True
            self._cond.notify_all()
        self._signal.set()

    def _close(self, reason: str,
               error: Optional[BaseException] = None) -> None:
        with self._cond:
            if self._reason is not None:
                return
            self._reason = reason
            self._cond.notify_all()
        self._signal.set()
        if reason == "finished":
            self._done._fulfill(list(self.request.tokens))
        elif reason == "expired":
            err = error or self.request.status.error or DeadlineExceeded(
                "request expired", tokens=list(self.request.tokens))
            self._done._reject(err)
        else:
            self._done._reject(PromiseCancelled())

    # -------------------------------------------------------- consumer side
    @property
    def lagging(self) -> bool:
        """True once the consumer fell behind the decode loop by more
        than ``config.stream_buffer`` tokens (sticky)."""
        return self._lagging

    @property
    def received(self) -> int:
        """Total tokens delivered to this stream so far."""
        with self._cond:
            return len(self._toks)

    @property
    def pending(self) -> int:
        """Tokens delivered but not yet consumed by this iterator."""
        with self._cond:
            return len(self._toks) - self._yielded

    @property
    def done(self) -> bool:
        return self._reason is not None

    @property
    def reason(self) -> Optional[str]:
        """``None`` while streaming; "finished", "cancelled" or "expired"
        once closed."""
        return self._reason

    def cancel(self) -> bool:
        """Cancel the underlying request. When this returns, no further
        token will be delivered — including tokens of a decode step
        already in flight."""
        return self.request.cancel()

    def tokens(self) -> Promise:
        """Awaitable/blockable promise for the *complete* token list
        (identical to retirement delivery). Rejects ``PromiseCancelled``
        on cancel and ``DeadlineExceeded`` on expiry."""
        return self._done.then(lambda toks: list(toks))

    def text(self) -> Promise:
        """``await stream.text()`` — the finished generation through the
        client's detokenizer. Same rejection contract as ``tokens()``."""
        return self._done.then(self._detokenize)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Blocking ``tokens()`` for sync callers."""
        return self.tokens().result(timeout)

    # ------------------------------------------------------------- sync iter
    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        with self._cond:
            while True:
                if self._yielded < len(self._toks):
                    tok = self._toks[self._yielded]
                    self._yielded += 1
                    return tok
                if self._reason is not None:
                    raise StopIteration
                self._cond.wait()

    # ------------------------------------------------------------ async iter
    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        while True:
            # arm FIRST, then check, then await: a publish racing between
            # the check and the await settles the armed promise, so the
            # consumer cannot sleep through it (Signal contract)
            wakeup = self._signal.wait()
            with self._cond:
                if self._yielded < len(self._toks):
                    tok = self._toks[self._yielded]
                    self._yielded += 1
                    return tok
                if self._reason is not None:
                    raise StopAsyncIteration
            await wakeup


class Session:
    """A configuration scope over a ``ServeClient``: defaults for every
    ``generate()`` call (overridable per call), plus bulk cancellation."""

    def __init__(self, client: "ServeClient",
                 defaults: GenerationConfig) -> None:
        self.client = client
        self.defaults = defaults
        self._streams: List[TokenStream] = []
        self._lock = threading.Lock()

    def generate(self, prompt: Any,
                 config: Optional[GenerationConfig] = None,
                 **overrides: Any) -> TokenStream:
        """Submit one generation, return its ``TokenStream``.

        ``config`` replaces the session defaults wholesale; ``overrides``
        are individual ``GenerationConfig`` fields layered on top of
        whichever base applies — all validated here, at admission.
        """
        base = config if config is not None else self.defaults
        cfg = base.merged(**overrides) if overrides else base
        request = Request(prompt, cfg)
        tr = _obs.TRACE
        if tr is not None and tr.want(request.req_id):
            # client-side edge of the timeline: everything between this
            # instant and the tier's own req.submit is client overhead
            tr.evt(_obs_events.REQ_SUBMIT, request.req_id, "client")
        stream = TokenStream(request, detokenize=self.client.detokenize)
        self.client.submit(request)
        with self._lock:
            # lazily prune closed streams so a long-lived session doesn't
            # pin every past generation's token list
            self._streams = [s for s in self._streams if not s.done]
            self._streams.append(stream)
        return stream

    @property
    def streams(self) -> List[TokenStream]:
        """Streams not yet pruned (every open one, plus recently closed
        ones generate() hasn't swept yet)."""
        with self._lock:
            return list(self._streams)

    def cancel_all(self) -> int:
        """Best-effort cancel of every stream this session opened;
        returns how many actually transitioned to cancelled."""
        return sum(1 for s in self.streams if s.cancel())


class ServeClient:
    """Process-local serving client: owns an ``EngineLike`` tier and the
    one thread driving its serve loop, so callers (sync or async, any
    thread) only ever touch sessions and streams.

    Build it over a model (``ServeClient(cfg, params, max_batch=8, ...)``
    — engine kwargs pass through to ``ServeEngine``) or wrap ANY tier
    satisfying ``serve.protocol.EngineLike``
    (``ServeClient(engine=serve_engine_or_disagg_or_router)``): the
    client speaks only the protocol surface (``submit``/``step``/
    ``metrics``/``shutdown`` plus the ``batcher``/``idle`` drain
    contract), so one client binds to the colocated engine, the
    disaggregated server, or the multi-replica router interchangeably.
    The serve loop starts lazily with the first submission; ``close()``
    drains and joins it. Usable as a context manager.
    """

    def __init__(self, cfg: Any = None, params: Any = None, *,
                 engine: Optional[EngineLike] = None,
                 detokenize: Optional[Callable[[List[int]], str]] = None,
                 defaults: Optional[GenerationConfig] = None,
                 idle_sleep: float = 5e-5,
                 **engine_kwargs: Any) -> None:
        if engine is None:
            if cfg is None or params is None:
                raise ValueError(
                    "ServeClient needs (cfg, params) or engine=")
            engine = ServeEngine(cfg, params, **engine_kwargs)
        elif engine_kwargs:
            raise ValueError("engine= and engine kwargs are exclusive")
        elif not isinstance(engine, EngineLike):
            raise TypeError(
                f"engine= must satisfy serve.protocol.EngineLike, got "
                f"{type(engine).__name__}")
        self.serve: EngineLike = engine
        self.detokenize = detokenize or _default_detokenize
        self.defaults = defaults or GenerationConfig()
        self._idle_sleep = idle_sleep
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._closed = False
        self._loop_error: Optional[BaseException] = None
        # live requests, so a dying loop can cancel them (closing their
        # streams) instead of stranding consumers; pruned on submit
        self._live: List[Request] = []
        self._live_lock = threading.Lock()

    # -------------------------------------------------------------- sessions
    def session(self, config: Optional[GenerationConfig] = None,
                **defaults: Any) -> Session:
        """A new ``Session``; ``defaults`` are ``GenerationConfig`` fields
        layered over the client defaults (or over ``config``)."""
        base = config if config is not None else self.defaults
        return Session(self, base.merged(**defaults) if defaults else base)

    def generate(self, prompt: Any,
                 config: Optional[GenerationConfig] = None,
                 **overrides: Any) -> TokenStream:
        """One-off generation on an anonymous session."""
        return self.session().generate(prompt, config, **overrides)

    # ------------------------------------------------------------ loop/drive
    def submit(self, request: Request) -> Request:
        """Submit a raw ``Request`` (streams usually go via sessions)."""
        self._ensure_loop()
        self.serve.submit(request)   # may raise: track only accepted work
        with self._live_lock:
            self._live = [r for r in self._live if not r.is_terminal]
            self._live.append(request)
        if self._loop_error is not None:
            request.cancel()         # loop died while we were tracking
        return request

    def _ensure_loop(self) -> None:
        if self._loop_error is not None:
            # a crashed loop fails the client: silently restarting would
            # mask the error (and auto-cancel work against it). close()
            # re-raises; a fresh client is the recovery path.
            raise RuntimeError(
                "serve loop crashed; client is failed — close() it"
            ) from self._loop_error
        if self._thread is not None and self._thread.is_alive():
            return
        with self._thread_lock:
            if self._closed:
                raise RuntimeError("client is closed")
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="serve-client-loop", daemon=True)
                self._thread.start()

    def _loop(self) -> None:
        # the single decode-loop thread (ServeEngine is single-consumer):
        # admits, dispatches, and runs the completion continuations that
        # feed every TokenStream
        try:
            while not self._stop.is_set():
                if not self.serve.step():
                    time.sleep(self._idle_sleep)
        except BaseException as exc:
            # a dead loop must not strand anyone: consumers blocked on
            # streams of in-flight requests would otherwise wait forever,
            # and close() would hang on a drain that can no longer
            # happen. Cancel every live request (closing its stream and
            # rejecting its promises) and re-raise the error from
            # close() on the caller's thread. An error raised AFTER
            # close() signalled stop is teardown noise (the engine may be
            # shutting down under a step that overran the drain window):
            # abandoned requests are still cancelled, but the client is
            # not marked failed.
            if not self._stop.is_set():
                self._loop_error = exc
            with self._live_lock:
                live, self._live = self._live, []
            for req in live:
                req.cancel()

    def metrics(self) -> ServeMetrics:
        return self.serve.metrics()

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Close intake, drain in-flight work, stop the loop thread and
        shut the engine down."""
        with self._thread_lock:
            if self._closed:
                return
            self._closed = True
        self.serve.close_intake()
        thread = self._thread
        if thread is not None and thread.is_alive():
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while not (self.serve.batcher.drained and self.serve.idle):
                if not thread.is_alive():
                    break                       # loop died: don't hang
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(self._idle_sleep)
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        self.serve.shutdown()
        if self._loop_error is not None:
            raise self._loop_error

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

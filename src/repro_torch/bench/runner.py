"""Trace replay against any serving tier — the measurement loop.

``Replayer`` binds a ``Trace`` (``bench.trace``) to anything satisfying
``serve.protocol.EngineLike`` — the colocated ``ServeEngine``, the
disaggregated ``DisaggServer``, or the multi-replica ``Router`` —
through the ``ServeClient`` streaming surface, so the measured path is
the one applications actually use (admission, per-token continuation
delivery, stream publication), not a bench-only shortcut.

Per request it records:

* **TTFT** — arrival (the paced ``session.generate`` call) to first
  delivered token (``Request.ttft``).
* **inter-token latencies** — gaps between ``Request.token_times``
  entries, stamped in the engine's step-completion continuations at the
  instant each token batch is committed/stream-published. Tokens
  accepted together (one speculative verify step) share a stamp: their
  gap is honestly zero.
* **completion status** — finished / expired / cancelled / refused
  (``QuotaExceeded`` at admission), and whether the deadline was met.

Replay modes follow the trace: open-loop traces are paced by arrival
offset on the submitting thread (late submissions — the engine running
slower than the trace — are submitted immediately and the lag is the
measured queueing delay, exactly like an open-loop client); closed-loop
traces keep ``trace.closed_loop`` requests outstanding from worker
threads.

Multi-sample runs (``samples=``) replay the same trace repeatedly on the
same (warm) tier — run-to-run dispersion is then measurement noise, not
workload noise, and feeds ``bench.stats`` / ``bench.report``.

Counterpart of ``repro/bench/runner.py``, over the port's
``ServeClient``. Build the tier on the thread that owns the device's work
(on a CUDA device the engine captures its step graphs there) and hand it
to the ``Replayer``: the client's loop thread steps it, and the replaying
thread only submits and waits.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from repro_torch.bench.stats import percentile
from repro_torch.bench.trace import Trace, TraceRequest
from repro_torch.obs.recorder import Recorder
from repro_torch.serve.api import ServeClient
from repro_torch.serve.config import GenerationConfig, QuotaExceeded
from repro_torch.serve.protocol import EngineLike
from repro_torch.serve.request import Request


@dataclasses.dataclass
class RequestRecord:
    """Measured outcome of one replayed trace request."""

    index: int                        # position in the trace
    tenant: str
    priority: int
    status: str                       # finished|expired|cancelled|refused
    arrival_s: float                  # offset from sample start (actual)
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None
    n_tokens: int = 0
    itl_s: List[float] = dataclasses.field(default_factory=list)
    deadline_s: Optional[float] = None
    deadline_met: Optional[bool] = None   # None: no deadline configured

    @property
    def finished(self) -> bool:
        return self.status == "finished"

    @property
    def good(self) -> bool:
        """Counts toward goodput: finished AND met its deadline (a
        request without a deadline only needs to finish)."""
        return self.finished and self.deadline_met is not False


@dataclasses.dataclass
class RunResult:
    """One replay sample: per-request records plus derived SLO metrics."""

    trace_name: str
    tier: str
    sample: int
    duration_s: float
    records: List[RequestRecord]
    closed_loop: Optional[int] = None
    engine_metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------ aggregates
    @property
    def ttfts(self) -> List[float]:
        return [r.ttft_s for r in self.records if r.ttft_s is not None]

    @property
    def itls(self) -> List[float]:
        return [g for r in self.records for g in r.itl_s]

    @property
    def tokens_delivered(self) -> int:
        return sum(r.n_tokens for r in self.records)

    def count(self, status: str) -> int:
        return sum(1 for r in self.records if r.status == status)

    def metrics(self) -> Dict[str, float]:
        """The flat headline-metric dict ``bench.report``/``bench.stats``
        summarize across samples."""
        n = len(self.records)
        dur = max(self.duration_s, 1e-9)
        good = [r for r in self.records if r.good]
        good_tokens = sum(r.n_tokens for r in good)
        ttfts, itls = self.ttfts, self.itls
        with_deadline = [r for r in self.records
                         if r.deadline_met is not None]
        out = {
            "makespan_s": self.duration_s,
            "tokens_per_s": self.tokens_delivered / dur,
            "goodput_tokens_per_s": good_tokens / dur,
            "goodput_requests_per_s": len(good) / dur,
            "finished_frac": self.count("finished") / n if n else 0.0,
            "expired": float(self.count("expired")),
            "refused": float(self.count("refused")),
            "ttft_mean_s": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            "ttft_p50_s": percentile(ttfts, 0.50),
            "ttft_p99_s": percentile(ttfts, 0.99),
            "ttft_p999_s": percentile(ttfts, 0.999),
            "itl_p50_s": percentile(itls, 0.50),
            "itl_p99_s": percentile(itls, 0.99),
            "itl_p999_s": percentile(itls, 0.999),
        }
        if with_deadline:
            out["deadline_met_frac"] = (
                sum(1 for r in with_deadline if r.deadline_met)
                / len(with_deadline))
        return out


def _config_for(entry: TraceRequest) -> GenerationConfig:
    return GenerationConfig(max_tokens=entry.max_tokens,
                            tenant=entry.tenant,
                            priority=entry.priority,
                            deadline_s=entry.deadline_s)


def _record(index: int, entry: TraceRequest, req: Optional[Request],
            t0: float) -> RequestRecord:
    if req is None:                      # refused at admission (quota)
        return RequestRecord(index=index, tenant=entry.tenant,
                             priority=entry.priority, status="refused",
                             arrival_s=entry.arrival_s,
                             deadline_s=entry.deadline_s)
    times = list(req.token_times)
    rec = RequestRecord(
        index=index, tenant=entry.tenant, priority=entry.priority,
        status=req.req_state.value,
        arrival_s=req.arrival_time - t0,
        ttft_s=req.ttft,
        latency_s=req.latency,
        n_tokens=len(times),
        itl_s=[b - a for a, b in zip(times, times[1:])],
        deadline_s=entry.deadline_s)
    if entry.deadline_s is not None:
        rec.deadline_met = (req.req_state.value == "finished"
                            and req.finish_time is not None
                            and req.finish_time
                            <= req.arrival_time + entry.deadline_s)
    return rec


class Replayer:
    """Owns a ``ServeClient`` over one tier and replays traces at it.

    ``tier`` is an ``EngineLike`` instance or a zero-arg factory; either
    way the Replayer owns the resulting tier and ``close()`` shuts it
    down (``with Replayer(...) as rp:`` is the usual shape). One
    Replayer can run many traces/samples back-to-back on the same warm
    tier — that is the point: warmup happens once, and every sample
    after it measures the serving path, not first calls.
    """

    def __init__(self, tier: Union[EngineLike, Callable[[], EngineLike]],
                 *, name: Optional[str] = None,
                 recorder: Optional[Recorder] = None) -> None:
        engine = tier() if callable(tier) and not isinstance(
            tier, EngineLike) else tier
        self.client = ServeClient(engine=engine)
        self.tier_name = name or type(engine).__name__
        #: optional ``obs.Recorder``: measured samples run traced (warmup
        #: and the throwaway replay stay untraced), accumulating request
        #: timelines + lifecycle histograms for SLO cause attribution
        self.recorder = recorder
        self._warmed = False

    # ------------------------------------------------------------------ runs
    def run(self, trace: Trace, *, samples: int = 1,
            warmup: Optional[int] = 2,
            timeout: float = 300.0) -> List[RunResult]:
        """Replay ``trace`` ``samples`` times; one ``RunResult`` each.

        ``warmup``: how many untimed throwaway requests to run before the
        first sample (the first call at each prefill and suffix shape);
        ``None``/``0`` skips. Warm prompts are drawn from a seed-derived
        stream disjoint from the trace ordering, and their pages are
        released before measurement starts.
        """
        if samples < 1:
            raise ValueError(f"samples must be >= 1, got {samples}")
        if warmup and not self._warmed:
            self._run_warmup(trace, int(warmup), timeout)
            # one untimed throwaway replay: first calls whose shapes
            # depend on scheduling coincidence (how many requests admit in
            # one tick, which prompt lengths meet) and the allocator's
            # growth to the trace's own peak happen on the pattern the
            # trace produces, not inside the first measured sample
            self._run_once(trace, -1, timeout)
            self._warmed = True
        if self.recorder is not None:
            # trace only the measured window: warmup and the throwaway
            # replay above ran with tracing off
            self.recorder.start()
        try:
            return [self._run_once(trace, i, timeout)
                    for i in range(samples)]
        finally:
            if self.recorder is not None:
                self.recorder.stop()

    def _run_warmup(self, trace: Trace, n: int, timeout: float) -> None:
        # cover every distinct prompt-length *shape* the trace will hit
        # (each length is its own first eager prefill: cuBLAS's choice of
        # GEMM for the shape, the caching allocator's first blocks of that
        # size), then pad to n, so measured samples time serving, not
        # first calls
        vocab = int(trace.meta.get("vocab_size", 512))
        plens = sorted({len(r.prompt) for r in trace.requests}) or [8]
        rng = random.Random(int(trace.meta.get("seed", 0)) ^ 0x5EED)
        session = self.client.session()
        reqs = []
        # run warm requests as long as the longest trace request: paths
        # that only trigger deep into decode (e.g. positions past the
        # prefill footprint, a verify window across a page) run now, not
        # mid-sample
        warm_tokens = max([2] + [r.max_tokens for r in trace.requests])

        def warm(prompt: List[int]) -> None:
            reqs.append(session.generate(prompt, GenerationConfig(
                max_tokens=warm_tokens)).request)

        for i in range(max(n, len(plens))):
            plen = plens[i % len(plens)]
            warm([rng.randrange(vocab) for _ in range(plen)])
        # shared-prefix traces also hit the chunked suffix-prefill path
        # (another eager shape per (plen, shared_len)): warm it
        # with an adjacent pair sharing a prefix disjoint from the trace
        shared = int(trace.meta.get("shared_len") or 0)
        if shared > 0:
            for plen in plens:
                if plen <= shared:
                    continue
                base = [rng.randrange(vocab) for _ in range(plen)]
                tail = [rng.randrange(vocab)
                        for _ in range(plen - shared)]
                warm(base)
                warm(base[:shared] + tail)
        for r in reqs:
            r.wait(timeout=timeout)

    def _run_once(self, trace: Trace, sample: int,
                  timeout: float) -> RunResult:
        if trace.closed_loop is not None:
            return self._run_closed(trace, sample, timeout)
        return self._run_open(trace, sample, timeout)

    def _run_open(self, trace: Trace, sample: int,
                  timeout: float) -> RunResult:
        session = self.client.session()
        submitted: List[Optional[Request]] = [None] * len(trace.requests)
        t0 = time.monotonic()
        for i, entry in enumerate(trace.requests):
            lag = entry.arrival_s - (time.monotonic() - t0)
            if lag > 0:
                time.sleep(lag)
            try:
                stream = session.generate(list(entry.prompt),
                                          _config_for(entry))
                submitted[i] = stream.request
            except QuotaExceeded:
                submitted[i] = None
        return self._collect(trace, sample, submitted, t0, timeout)

    def _run_closed(self, trace: Trace, sample: int,
                    timeout: float) -> RunResult:
        session = self.client.session()
        submitted: List[Optional[Request]] = [None] * len(trace.requests)
        it = iter(range(len(trace.requests)))
        lock = threading.Lock()
        t0 = time.monotonic()

        def worker() -> None:
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                entry = trace.requests[i]
                try:
                    stream = session.generate(list(entry.prompt),
                                              _config_for(entry))
                    submitted[i] = stream.request
                except QuotaExceeded:
                    submitted[i] = None
                    continue
                # closed loop: hold this lane until the request retires
                submitted[i].wait(timeout=timeout)

        n_workers = min(trace.closed_loop or 1, len(trace.requests))
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + 10.0)
        return self._collect(trace, sample, submitted, t0, timeout)

    def _collect(self, trace: Trace, sample: int,
                 submitted: Sequence[Optional[Request]], t0: float,
                 timeout: float) -> RunResult:
        deadline = time.monotonic() + timeout
        for req in submitted:
            if req is None:
                continue
            if not req.wait(timeout=max(0.0, deadline - time.monotonic())):
                req.cancel()             # sample overran: fail it visibly
        records = [_record(i, entry, req, t0)
                   for i, (entry, req)
                   in enumerate(zip(trace.requests, submitted))]
        finish = [req.finish_time for req in submitted
                  if req is not None and req.finish_time is not None]
        duration = (max(finish) - t0) if finish \
            else (time.monotonic() - t0)
        return RunResult(trace_name=trace.name, tier=self.tier_name,
                         sample=sample, duration_s=duration,
                         records=records, closed_loop=trace.closed_loop,
                         engine_metrics=self._metrics_snapshot())

    def _metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-safe scalar slice of the tier's metrics() mapping."""
        out = {}
        for k, v in dict(self.client.metrics()).items():
            if isinstance(v, (bool, int, float, str)):
                out[k] = v
        return out

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        self.client.close()

    def __enter__(self) -> "Replayer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def replay(tier: Union[EngineLike, Callable[[], EngineLike]],
           trace: Trace, *, samples: int = 1, warmup: Optional[int] = 2,
           timeout: float = 300.0, name: Optional[str] = None,
           recorder: Optional[Recorder] = None) -> List[RunResult]:
    """One-shot convenience: build a ``Replayer`` over ``tier``, replay
    ``trace`` ``samples`` times, shut the tier down, return the results.
    Keep a ``Replayer`` instead when the tier should stay warm across
    traces (the saturation sweep does)."""
    with Replayer(tier, name=name, recorder=recorder) as rp:
        return rp.run(trace, samples=samples, warmup=warmup,
                      timeout=timeout)

"""A serve cell: ``repro_torch.serve.api.ServeClient`` over a dense-mode
``ServeEngine``, driven by a closed loop of clients for a timed window.

Set-up makes the weights from the seed, builds the engine (which captures
the decode step as a CUDA graph), and seats every client's first request,
so the window opens on full slots. The first requests serve a share
(i + 0.5) / clients of their drawn output, client i's, so that they end
spread over the window as in a loop that has run for a while, not all at
once. In the window each finished request is followed at once by its
client's next. After it closes the loop sends nothing, waits until every
request sent in the window has its first token, and cancels what is left.

The end-to-end metrics read the requests' own stamps (``Request``'s
submission time, first-token time and per-token delivery times, stamped in
the step continuations) over the window: tokens delivered in it over its
seconds, the 95th percentile of time to first token over every request
sent in it, and of the gaps between consecutive tokens of a request that
both fall in it. The traced run arms the program's tracer over the window
and profiles a steady slice in its middle.
"""
from __future__ import annotations

import queue
import random
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from perfbench import devtrace
from perfbench.reference.check import widest_gaps
from perfbench.traffic.closed_loop import ClosedLoop
from perfbench.traffic.stats import percentile
from perfbench.weights import make_params

#: seconds a request sent in the window may take to its first token after
#: the window closed before it counts as failed
FIRST_TOKEN_WAIT_S = 60.0
#: seconds the loop runs between the profiler's start-up and its slice
SETTLE_S = 5.0


class ServeRun:
    """What a serve run leaves for the metric readers: the window, the
    engine's counters at its edges, every request, and (traced) the
    tracer's events and the profiled slice."""

    def __init__(self, cell: Mapping[str, Any], model: Mapping[str, Any],
                 dtype: str) -> None:
        self.cell, self.model, self.dtype = cell, model, dtype
        self.max_batch = int(cell["engine"]["max_batch"])
        self.t_open = self.t_close = 0.0
        self.stats0: Dict[str, Any] = {}
        self.stats1: Dict[str, Any] = {}
        self.pending0 = self.pending1 = 0
        self.requests: List[Any] = []
        self.events: List[Any] = []
        self.timeline: Optional[devtrace.Timeline] = None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def delta(self, key: str) -> float:
        return self.stats1[key] - self.stats0[key]

    def in_window(self, t: float) -> bool:
        return self.t_open <= t < self.t_close

    # ------------------------------------------------ end-to-end metrics
    def tokens_in_window(self) -> int:
        return sum(1 for r in self.requests for t in r.token_times
                   if self.in_window(t))

    def ttfts_ms(self) -> List[float]:
        return [(r.first_token_time - r.arrival_time) * 1e3
                for r in self.requests
                if self.in_window(r.arrival_time)
                and r.first_token_time is not None]

    def gaps_ms(self) -> List[float]:
        out = []
        for r in self.requests:
            tt = r.token_times
            out.extend((b - a) * 1e3 for a, b in zip(tt, tt[1:])
                       if self.t_open <= a and b < self.t_close)
        return out

    def end_to_end(self) -> Dict[str, float]:
        return {"decode_tokens_per_s": self.tokens_in_window()
                / self.window_s,
                "ttft_p95_ms": percentile(self.ttfts_ms(), 0.95),
                "itl_p95_ms": percentile(self.gaps_ms(), 0.95)}


def _pick_samples(finished: List[Any], seed: int, want_tokens: int
                  ) -> List[Any]:
    """The longest finished request, then others drawn from the seed until
    ``want_tokens`` served tokens are in the sample."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: len(r.prompt) + len(r.tokens))
    rest = [r for r in finished if r is not longest]
    random.Random(seed).shuffle(rest)
    out, n = [longest], len(longest.tokens)
    for r in rest:
        if n >= want_tokens:
            break
        out.append(r)
        n += len(r.tokens)
    return out


def run(cell: Mapping[str, Any], conf: Mapping[str, Any], cfg: Any,
        seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Dict[str, Any]:
    """One run of a serve cell; returns the run's object, its set-up
    seconds, counts and the output check's numbers."""
    from repro_torch.core import TensorOp
    from repro_torch.obs import tracer as obs
    from repro_torch.serve.api import ServeClient
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.request import RequestState

    dtype = conf["serve"]["dtype"]
    r = ServeRun(cell, conf["model"], dtype)
    params = make_params(cfg, seed, device)
    engine = ServeEngine(cfg, params, device=device, paged=False,
                         **cell["engine"])
    client = ServeClient(engine=engine)
    session = client.session()
    loop = ClosedLoop(cell["traffic"], seed, cfg.vocab_size)
    done: "queue.Queue[int]" = queue.Queue()    # clients whose request ended

    def send(i: int, share: float = 1.0) -> None:
        prompt, olen = loop.next()
        olen = max(1, int(np.ceil(olen * share)))
        stream = session.generate(prompt, max_tokens=olen,
                                  stream_buffer=1 << 30)
        r.requests.append(stream.request)
        stream.tokens().then(lambda _: done.put(i), lambda _: done.put(i))

    # set-up: every slot seated, each first request at its share
    for i in range(loop.clients):
        send(i, (i + 0.5) / loop.clients)
    deadline = time.monotonic() + 600
    while any(q.first_token_time is None for q in r.requests):
        if time.monotonic() > deadline:
            raise RuntimeError("set-up: the first requests never started")
        time.sleep(0.005)
    while not done.empty():   # a first request that already finished
        send(done.get())

    def drive(until: float) -> None:
        """The closed loop: each finished request's client sends again."""
        while True:
            now = time.monotonic()
            if now >= until:
                return
            try:
                i = done.get(timeout=min(0.05, until - now))
            except queue.Empty:
                continue
            send(i)

    if trace:
        obs.start(capacity=1 << 21)
    r.pending0 = TensorOp.PENDING_AT_FIRST_POLL
    r.stats0 = dict(engine.stats)
    r.t_open = time.monotonic()
    setup_s = r.t_open - t_start
    drive(r.t_open + seconds)
    r.t_close = time.monotonic()
    r.stats1 = dict(engine.stats)
    r.pending1 = TensorOp.PENDING_AT_FIRST_POLL
    slice_ = None
    if trace:
        tr = obs.stop()
        r.events = tr.drain() if tr is not None else []
        # the profiled slice: the same loop, after the window, once it has
        # refilled the slots that emptied while the profiler started
        slice_ = devtrace.Slice(cell["name"])
        slice_.prepare()
        drive(time.monotonic() + SETTLE_S)
        slice_.start()
        drive(time.monotonic() + min(3.0, seconds / 3))
        slice_.stop()

    # the window's last requests reach their first token; the rest stop
    late = [q for q in r.requests if r.in_window(q.arrival_time)]
    deadline = time.monotonic() + FIRST_TOKEN_WAIT_S
    while any(q.first_token_time is None and not q.is_terminal
              for q in late) and time.monotonic() < deadline:
        time.sleep(0.005)
    for q in r.requests:
        if not q.is_terminal:
            q.cancel()
    client.close(timeout=60)
    if device.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    if slice_ is not None:
        r.timeline = slice_.read()

    failed = sum(1 for q in late if q.first_token_time is None) + sum(
        1 for q in r.requests if q.req_state is RequestState.EXPIRED)
    finished = [q for q in r.requests
                if q.req_state is RequestState.FINISHED]
    samples = _pick_samples(finished, seed,
                            int(cell["check"]["sample_tokens"]))
    del client, engine, session
    if device.type == "cuda":
        torch.cuda.empty_cache()
    gaps = widest_gaps(conf["model"], params,
                       [(np.asarray(q.prompt), q.tokens) for q in samples],
                       device)
    limit = float(cell["check"]["limit"])
    checks = {"widest_gap": {"value": gaps["served"], "limit": limit}}
    correct = bool(samples) and gaps["served"] <= limit
    return {"run": r, "setup_s": setup_s, "peak": peak,
            "attempted": len(r.requests), "failed": failed,
            "correct": correct, "checks": checks,
            "sampled_tokens": sum(len(q.tokens) for q in samples),
            "samples": samples, "params": params}

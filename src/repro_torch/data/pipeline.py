"""Continuation-driven input pipeline (the port's copy of
``repro/data/pipeline.py``, imports rewritten: its batches are numpy
arrays, byte-equal to the reference's; the trainer uploads them).

The paper's Listing-2 pattern applied to data loading: each prefetch fill is
an asynchronous host task whose *continuation* delivers its batch, without a
dedicated coordinator loop. Fills are bounded by consumption: taking a batch
posts the next fill (like re-posting a receive once a message is consumed),
so at most ``depth`` batches are made ahead of the trainer and fill threads
never race it for the interpreter. The trainer never blocks on I/O unless the
buffer is empty (the time it waits is the tracer's ``data.wait`` span), and
progress happens on whatever thread touches the engine.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.core import Engine, HostTaskOp, Status
from repro_torch.models.common import AUDIO, VLM, ModelConfig
from repro_torch.obs import events as _obs_events
from repro_torch.obs import tracer as _obs


class SyntheticTokenSource:
    """Deterministic synthetic batches shaped per architecture family.

    ``fill_latency_s`` simulates storage latency so prefetch overlap is
    observable in tests/benchmarks.
    """

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, fill_latency_s: float = 0.0) -> None:
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.fill_latency_s = fill_latency_s
        self._seed = seed

    def _token_stream(self, rng, B: int, S: int) -> np.ndarray:
        """Learnable synthetic language: a deterministic affine bigram map
        with 10% noise — CE can fall from ln(V) toward ≈ 0.1·ln(V), so the
        e2e trainer demonstrably learns (uniform-random tokens cannot)."""
        V = self.cfg.vocab_size
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, S)) < 0.1
        randoms = rng.integers(0, V, (B, S))
        for t in range(1, S):
            nxt = (toks[:, t - 1] * 31 + 7) % V
            toks[:, t] = np.where(noise[:, t], randoms[:, t], nxt)
        return toks.astype(np.int32)

    def make_batch(self, index: int) -> Dict[str, np.ndarray]:
        if self.fill_latency_s:
            time.sleep(self.fill_latency_s)
        rng = np.random.default_rng(self._seed * 100003 + index)
        cfg, B, S = self.cfg, self.global_batch, self.seq_len
        if cfg.family == AUDIO:
            dec = min(cfg.max_target_len, 448)
            return {
                "audio_embed": rng.standard_normal(
                    (B, S, cfg.frontend_dim)).astype(np.float32),
                "dec_tokens": self._token_stream(rng, B, dec),
            }
        batch = {"tokens": self._token_stream(rng, B, S)}
        if cfg.family == VLM:
            batch["tokens"] = batch["tokens"][:, :S - cfg.n_patches]
            batch["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
        return batch


class PrefetchPipeline:
    """Double-buffered (depth-N) prefetch built on continuations: batch
    ``i`` is made once batch ``i - depth`` has been taken. ``start`` is the
    first batch's index (a restart skips the batches already trained on);
    ``max_batches`` bounds the indices."""

    def __init__(self, source: SyntheticTokenSource, engine: Engine, *,
                 depth: int = 2, max_batches: Optional[int] = None,
                 start: int = 0) -> None:
        self.source = source
        self.engine = engine
        self.depth = depth
        self.max_batches = max_batches
        self._pool = ThreadPoolExecutor(max_workers=depth,
                                        thread_name_prefix="data-fill")
        # thread="any": the executor thread that finished a fill may run the
        # continuation immediately — lowest-latency handoff (paper §3.5).
        self.cr = engine.continue_init({"mpi_continue_thread": "any"})
        # index-ordered delivery: fills complete out of order under
        # concurrency, but training must consume batch i at step i for
        # reproducible restarts
        self._ready: Dict[int, Any] = {}
        self._next_deliver = start
        self._cv = threading.Condition()
        self._posted = start
        self.stats = {"fills": 0, "get_waits": 0}
        for _ in range(depth):
            self._post_fill()

    def _post_fill(self) -> None:
        # called by the consumer only (construction, then get_next)
        if self.max_batches is not None and self._posted >= self.max_batches:
            return
        index = self._posted
        self._posted += 1
        fut = self._pool.submit(self.source.make_batch, index)
        op = HostTaskOp(fut)
        flag = self.engine.continue_when(op, self._on_fill, index,
                                         status=[None], cr=self.cr)
        if flag:   # already complete: handle immediately (paper §2.2)
            self._on_fill([op.status], index)

    def _on_fill(self, statuses, index) -> None:
        status: Status = statuses[0]
        if status.error is not None:
            raise status.error
        with self._cv:
            self._ready[index] = status.payload
            self.stats["fills"] += 1
            self._cv.notify_all()

    def get_next(self, timeout: float = 30.0) -> Dict[str, np.ndarray]:
        """The next batch in index order; a batch taken posts the fill
        ``depth`` ahead of it."""
        t_wait = None
        while True:
            with self._cv:
                if self._next_deliver in self._ready:
                    batch = self._ready.pop(self._next_deliver)
                    self._next_deliver += 1
                    break
            if t_wait is None:
                t_wait = time.monotonic()
                deadline = t_wait + timeout
            self.stats["get_waits"] += 1
            self.engine.tick()      # progress while waiting
            with self._cv:
                if self._next_deliver not in self._ready:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("prefetch pipeline starved")
                    self._cv.wait(timeout=min(remaining, 0.005))
        if t_wait is not None:
            tr = _obs.TRACE
            if tr is not None:
                tr.evt(_obs_events.DATA_WAIT, self._next_deliver - 1, "data",
                       ts=t_wait, dur=tr.now() - t_wait)
        self._post_fill()
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while self.max_batches is None or \
                self._next_deliver < self.max_batches:
            yield self.get_next()

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

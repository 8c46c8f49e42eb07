"""Disaggregated prefill/decode serving over the continuation transport.

Counterpart of ``repro/serve/disagg.py``. The paper's claim — completion
callbacks let a runtime overlap communication with computation instead
of blocking at phase boundaries — applied to the serving stack's biggest
phase boundary: prefill vs decode. Two *roles* run against one
continuation engine and talk **only** through ``core.transport`` ops
(never shared references):

* ``PrefillWorker`` (rank 0) — admits routed requests into its own
  staging ``PagePool``, runs *chunked* prefill (one fused paged-suffix
  step per ``chunk_pages`` window, eager), and ships each finished KV page
  to the decode role as a ``KVBlockMsg`` of device tensors. The worker's
  staging pages are released by a ``when_all`` continuation over the
  block sends (delivery complete = safe to recycle).
* ``DecodeWorker`` (rank 1) — a ``ServeEngine`` whose admission path is
  remote ingestion instead of local prefill: a standing control receive
  accepts per-request headers (allocate the full decode footprint, post
  one block receive per shipped page), each block receive's delivery
  continuation installs the page into the decode ``PagePool``
  (``import_page``, in place), and once the last block lands *and* the
  prefill role has delivered the first token, the request queues for a
  decode slot through a priority ``Batcher`` and is seated via the shared
  ``ServeEngine._seat_slot``. Decode pages release at retirement through
  the unchanged slot machinery.
* ``DisaggServer`` — the router/facade: one intake ``Batcher`` admits in
  QoS order and hands each request to the prefill role. It exposes the
  ``ServeEngine`` surface, so ``serve.api.ServeClient`` token streams run
  over it unchanged.

Wire protocol, as in the reference: ``CTRL_TAG`` carries
``PrefillHeader`` → ``PrefillDone`` or ``PrefillAbort``;
``block_tag(req_id)`` carries one ``KVBlockMsg`` per prompt page, in page
order.

What the card changes. In the reference, JAX arrays order themselves
across the roles by data dependency. On the card a tensor is only
*queued* when the prefill role ships it, the decode role reads it on
another stream, and the decode graphs read the pool through fixed
addresses. So:

* the prefill role owns a CUDA stream: every chunk, every export and
  every ``isend`` of a block is queued under it, whichever thread runs
  the call. Each chunk is followed on that stream by the export
  (``PagePool.export_page``, a copy into fresh tensors) of every page it
  completes, and the block is sent right away: the transport records a
  ``TensorOp`` behind the copy and holds the message until a poll finds
  it complete. That held send *is* the reference's continuation on the
  export's completion, with its ``isend`` as the op's ready hook: the
  block ships the moment its copy has run, while the next chunk runs;
* the decode role works on the engine's stream (the current stream when
  it was constructed): ``_on_block`` claims the message for that stream
  (``take``) and copies the page into the pool in place, so the captured
  decode and verify graphs see it, ordered before any step queued later.
  Continuations may run inside any transport call, under the other
  role's stream, so each role's callbacks that queue device work set
  their stream themselves;
* the first token comes down to pinned host memory right behind the last
  chunk; continuations read only that copy, and the decode role uploads
  it (pinned, non-blocking) to seat the request. The transport keeps
  post order per (source, dest), so the decode role sees every block a
  request shipped before that request's ``PrefillDone`` or
  ``PrefillAbort``.

Token identity: the decode role runs the very same fused paged steps as
the colocated engine, and chunked prefill appends the same KV the
colocated suffix path would. The prefill role keeps no prefix cache of
its own (staging pages are recycled right after shipping).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import (ContinueFlags, Engine, OpState, Scheduler,
                              TensorOp, Transport, when_all)
from repro_torch.core.transport import take
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.obs import events as _obs_events
from repro_torch.obs import tracer as _obs
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.drafter import Drafter
from repro_torch.serve.engine import ServeEngine, _step_flags
from repro_torch.serve.kv_cache import PagePool, paged_supported, pages_for
from repro_torch.serve.metrics import ServeMetrics, transport_fields
from repro_torch.serve.request import Request, RequestState, summarize
from repro_torch.serve.steps import make_fused_paged_suffix_step
from repro_torch.util import resolve_device

PREFILL_RANK = 0
DECODE_RANK = 1

# control-plane channel (headers / done / abort); data-plane channels are
# per-request so per-tag transport stats separate KV bandwidth from
# control chatter
CTRL_TAG = 7001
_BLOCK_TAG_BASE = 1 << 16

_FLAGS = ContinueFlags(enqueue_complete=True)


def block_tag(req_id: int) -> int:
    """Per-request KV-block channel tag."""
    return _BLOCK_TAG_BASE + req_id


# handoff-lifecycle ``_log`` kinds -> trace-event kinds. ``seat`` is
# omitted: ``ServeEngine._seat_slot`` (shared with the colocated path)
# already emits ``req.seat``.
_LOG_EVENTS = {
    "ship": _obs_events.REQ_KV_SHIP,
    "install": _obs_events.REQ_KV_IMPORT,
    "header": "req.kv.announce",
    "prefill_done": "req.prefill.done",
    "landed": "req.kv.landed",
    "abort": "req.abort",
    "prefill_released": _obs_events.REQ_PAGES_RELEASE,
}


def _trace_log(kind: str, req_id: int, rest: tuple, src: str) -> None:
    """Mirror a handoff-lifecycle record into the tracer (same sampling
    as every other ``req.*`` event, so timelines stay complete)."""
    tr = _obs.TRACE
    if tr is None:
        return
    ek = _LOG_EVENTS.get(kind)
    if ek is not None and tr.want(req_id):
        tr.evt(ek, req_id, src, meta=rest[0] if rest else None)


# --------------------------------------------------------------- messages
@dataclass(frozen=True)
class PrefillHeader:
    """Announces a request to the decode role: allocate the footprint
    for ``plen + max_new`` tokens and post ``n_ship`` block receives."""
    req_id: int
    plen: int
    max_new: int
    n_ship: int


@dataclass(frozen=True)
class PrefillDone:
    """Prefill finished; ``first_token`` was already delivered to the
    request at the prefill role (TTFT does not wait for seating)."""
    req_id: int
    first_token: int


@dataclass(frozen=True)
class PrefillAbort:
    """The request ended at the prefill role (cancel, deadline, stop
    sequence or single-token budget). ``shipped`` blocks were sent; the
    decode role drains/cancels accordingly."""
    req_id: int
    shipped: int


@dataclass(frozen=True)
class KVBlockMsg:
    """One shipped KV page: ``k``/``v`` device tensors of shape
    ``(n_layers, page_size, kv_heads, head_dim)``. ``nbytes`` lets the
    transport account the payload at its real wire size (eager vs
    rendezvous, per-tag byte counters); the transport finds the tensors
    in its fields and holds the message until they are written."""
    req_id: int
    index: int
    k: Any
    v: Any

    @property
    def nbytes(self) -> int:
        return int(self.k.nbytes) + int(self.v.nbytes)


# ---------------------------------------------------------- prefill role
class _PrefillJob:
    """Host bookkeeping for one request moving through chunked prefill."""

    __slots__ = ("req", "prompt", "plen", "n_ship", "ship", "table", "pos",
                 "exported", "shipped", "sends", "chunk_inflight", "done",
                 "aborted", "released")

    def __init__(self, req: Request, prompt: np.ndarray, n_ship: int,
                 table: List[int], ship: bool) -> None:
        self.req = req
        self.prompt = prompt
        self.plen = int(prompt.shape[0])
        self.n_ship = n_ship
        self.ship = ship                  # False: budget of 1, nothing ships
        self.table = table
        self.pos = 0                      # prompt tokens prefilled so far
        self.exported = 0                 # pages whose export is queued
        self.shipped = 0                  # block sends issued
        self.sends: List[Any] = []
        self.chunk_inflight = False
        self.done = False                 # all chunks computed
        self.aborted = False
        self.released = False


class PrefillWorker:
    """The prefill role: chunked prompt prefill + per-block KV shipping.

    Owns a small staging ``PagePool`` sized for in-flight prompts only;
    pages recycle as soon as a request's block sends complete, so the
    staging pool never grows with decode residency. Driven by the same
    loop thread as the decode role; all callbacks here are continuations.
    On a CUDA device it owns a stream, under which all of its device work
    is queued.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, engine: Engine,
                 transport: Transport, rank: int, peer: int,
                 page_size: int, total_pages: int, max_prompt_len: int,
                 chunk_pages: int = 1, max_jobs: int = 2,
                 events: Optional[List[tuple]] = None,
                 device: Any = "cuda") -> None:
        if not paged_supported(cfg):
            raise ValueError("disaggregated prefill requires a "
                             "paged-cache-capable model config")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.engine = engine
        self.transport = transport
        self.rank, self.peer = rank, peer
        self.page_size = int(page_size)
        self.max_jobs = max(1, int(max_jobs))
        self.pool = PagePool(cfg, total_pages, page_size, device=self.device)
        self.pool.ensure_arrays()
        self.stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # the params and the pool's zeros were queued on the caller's
            # stream; the pool's blocks are used on this one until freed
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            for t in self.pool.arrays.values():
                t.record_stream(self.stream)
        self._table_pages = pages_for(max_prompt_len, page_size)
        self._window = max(1, int(chunk_pages)) * self.page_size
        self._suffix_fn = make_fused_paged_suffix_step(
            cfg, self.page_size, lm.layer_views(params))
        self.cr = engine.continue_init()
        self._jobs: Dict[int, _PrefillJob] = {}
        self._queue: Deque[Request] = deque()   # routed, waiting for pages
        self._events = events
        self._retired: List[Request] = []
        self._lock = threading.Lock()
        self.bytes_shipped = 0
        self.stats = {"jobs": 0, "chunks": 0, "blocks_shipped": 0,
                      "retired": 0, "stopped": 0, "cancelled": 0,
                      "expired": 0, "aborted": 0, "deferred": 0,
                      # host seconds spent queueing chunks, exports and
                      # block sends (continuations the transport runs
                      # inline included)
                      "dispatch_s": 0.0}

    # ------------------------------------------------------------- intake
    @property
    def capacity(self) -> int:
        """How many more requests the router should hand over now."""
        return max(0, self.max_jobs - len(self._jobs) - len(self._queue))

    def start(self, req: Request) -> None:
        """Accept a routed request (may wait for staging pages)."""
        self._queue.append(req)

    def _activate(self) -> int:
        started = 0
        while self._queue and len(self._jobs) < self.max_jobs:
            req = self._queue[0]
            if req.req_state is RequestState.CANCELLED:
                self._queue.popleft()
                self.stats["cancelled"] += 1
                self._unannounce(req)
                continue
            if req.past_deadline():
                self._queue.popleft()
                if req.expire():
                    self.stats["expired"] += 1
                self._unannounce(req)
                continue
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            n_ship = pages_for(prompt.shape[0], self.page_size)
            table = self.pool.alloc(n_ship)
            if table is None:
                self.stats["deferred"] += 1
                break
            self._queue.popleft()
            tr = _obs.TRACE
            if tr is not None and tr.want(req.req_id):
                tr.evt(_obs_events.REQ_PAGES_ALLOC, req.req_id, "prefill",
                       meta=len(table))
            ship = req.max_new_tokens > 1
            job = _PrefillJob(req, prompt, n_ship, table, ship)
            self._jobs[req.req_id] = job
            self.stats["jobs"] += 1
            if ship:
                # announce before any chunk runs: the decode role posts
                # its block receives ahead of the first send
                self.transport.isend(self.rank, self.peer, CTRL_TAG,
                                     PrefillHeader(req.req_id, job.plen,
                                                   req.max_new_tokens,
                                                   n_ship))
                self._log("header", req.req_id)
            started += 1
        return started

    def _unannounce(self, req: Request) -> None:
        """A routed request died before prefill even started: the decode
        role may be expecting it — a zero-shipped abort clears that."""
        if req.max_new_tokens > 1:
            self.transport.isend(self.rank, self.peer, CTRL_TAG,
                                 PrefillAbort(req.req_id, 0))

    # --------------------------------------------------------------- loop
    def step(self) -> bool:
        """Dispatch the next chunk of every job with no chunk in flight."""
        with torch.cuda.stream(self.stream):
            progressed = bool(self._activate())
            for job in list(self._jobs.values()):
                if job.chunk_inflight or job.done or job.aborted:
                    continue
                req = job.req
                if req.req_state is RequestState.CANCELLED:
                    self.stats["cancelled"] += 1
                    self._abort(job)
                    continue
                if req.past_deadline():
                    if req.expire():
                        self.stats["expired"] += 1
                    self._abort(job)
                    continue
                self._dispatch_chunk(job)
                progressed = True
        return progressed

    # the engine's pinned, non-blocking host <-> device copies (they read
    # only ``self.device``)
    _upload = ServeEngine._upload
    _download = ServeEngine._download

    def _dispatch_chunk(self, job: _PrefillJob) -> None:
        """Queue the next chunk of ``job`` on the role's stream, then the
        export and send of every page it completes (the partial tail page
        counts once the whole prompt is in). Call under the stream."""
        t_host = time.perf_counter()
        W = self._window
        start = job.pos
        end = min(start + W, job.plen)
        tail = end - start
        # one upload for every operand: window tokens | start | tail | table
        ops = np.zeros(W + 2 + self._table_pages, np.int32)
        ops[:tail] = job.prompt[start:end]
        ops[W] = start
        ops[W + 1] = tail
        ops[W + 2:] = self.pool.null_page
        ops[W + 2:W + 2 + len(job.table)] = job.table
        dev = self._upload(ops)
        logits, _ = self._suffix_fn(
            self.params, self.pool.arrays, dev[:W].view(1, W),
            dev[W:W + 1], dev[W + 2:].view(1, -1), dev[W + 1:W + 2])
        job.chunk_inflight = True
        self.stats["chunks"] += 1
        first_host = None
        if end == job.plen:
            first = torch.argmax(logits[:, tail - 1], dim=-1).to(torch.int32)
            first_host = self._download(first)
            op = TensorOp(first, payload=first_host)
        else:
            op = TensorOp(logits)
        tr = _obs.TRACE
        t0 = (tr.now() if tr is not None and tr.want(job.req.req_id)
              else None)
        if job.ship:
            n_complete = job.n_ship if end == job.plen \
                else end // self.page_size
            for idx in range(job.exported, n_complete):
                self._on_export(job, idx,
                                self.pool.export_page(job.table[idx]))
            job.exported = n_complete
        self.stats["dispatch_s"] += time.perf_counter() - t_host
        self.engine.continue_when(op, self._on_chunk,
                                  (job, end, first_host, t0), cr=self.cr,
                                  flags=_step_flags(job.req.priority))

    def _on_chunk(self, statuses, meta) -> None:
        job, end, first_host, t0 = meta
        if t0 is not None:
            tr = _obs.TRACE
            if tr is not None:
                # one span per prefill chunk: dispatch -> device-complete,
                # interleaving with the per-block ship instants
                tr.evt(_obs_events.REQ_PREFILL, job.req.req_id, "prefill",
                       ts=t0, dur=tr.now() - t0, meta=end)
        job.chunk_inflight = False
        job.pos = end
        req = job.req
        if job.aborted:
            return
        if req.req_state is RequestState.CANCELLED:
            self.stats["cancelled"] += 1
            self._abort(job)
            return
        if req.past_deadline() and end < job.plen:
            # mid-prompt expiry: nothing delivered yet, fail cheaply (a
            # finished prompt falls through — the paid-for first token is
            # still returned, mirroring the colocated engine)
            if req.expire():
                self.stats["expired"] += 1
            self._abort(job)
            return
        if end < job.plen:
            return
        job.done = True
        self._log("prefill_done", req.req_id)
        # the host copy is complete by continuation time
        first = int(first_host[0])
        req.push_device_token(first)
        req.on_first_token()
        finished = req.deliver([first])
        if finished == "stop":
            self._retire(req, stopped=True)
            self._abort(job)
        elif req.remaining == 0:
            # budget of one: answered entirely at the prefill role — the
            # decode role was never involved (no header was sent)
            self._retire(req)
            self._abort(job, notify=job.ship)
        elif req.past_deadline():
            if req.expire():
                self.stats["expired"] += 1
            self._abort(job)
        else:
            self.transport.isend(self.rank, self.peer, CTRL_TAG,
                                 PrefillDone(req.req_id, first))
            self._maybe_finalize(job)

    def _on_export(self, job: _PrefillJob, idx: int,
                   kv: Dict[str, torch.Tensor]) -> None:
        """Send one exported page (call under the role's stream): the
        transport holds the block until the export's copy has run on the
        card, then delivers it."""
        msg = KVBlockMsg(job.req.req_id, idx, kv["k"], kv["v"])
        # logged before the send: a block the transport delivers at once
        # (a host tensor) is installed inside ``isend``
        self._log("ship", job.req.req_id, idx)
        op = self.transport.isend(self.rank, self.peer,
                                  block_tag(job.req.req_id), msg)
        job.sends.append(op)
        job.shipped += 1
        self.bytes_shipped += msg.nbytes
        self.stats["blocks_shipped"] += 1

    # ----------------------------------------------------------- teardown
    def _abort(self, job: _PrefillJob, notify: bool = True) -> None:
        """Stop shipping for a job (terminal at this role). ``notify``
        tells the decode role to tear its landing down — skipped only
        when no header was ever sent."""
        if job.aborted:
            return
        job.aborted = True
        self.stats["aborted"] += 1
        if notify and job.ship:
            self.transport.isend(self.rank, self.peer, CTRL_TAG,
                                 PrefillAbort(job.req.req_id, job.shipped))
            self._log("abort", job.req.req_id)
        self._maybe_finalize(job)

    def _maybe_finalize(self, job: _PrefillJob) -> None:
        """Release the staging pages when ALL block sends complete
        (delivery done — ``when_all([])`` is vacuous for unshipped jobs).
        A chunk still in flight writes them before any later chunk can:
        both queue on this role's stream."""
        if job.released or not (job.done or job.aborted):
            return
        job.released = True
        self.engine.continue_when(when_all(job.sends),
                                  self._on_ships_complete, job,
                                  cr=self.cr, flags=_FLAGS)

    def _on_ships_complete(self, statuses, job: _PrefillJob) -> None:
        self.pool.release(job.table)
        job.table = []
        self._jobs.pop(job.req.req_id, None)
        self._log("prefill_released", job.req.req_id)

    def _retire(self, req: Request, stopped: bool = False) -> None:
        if not req.retire():
            if req.req_state is RequestState.CANCELLED:
                self.stats["cancelled"] += 1
            return
        if stopped:
            self.stats["stopped"] += 1
        with self._lock:
            self._retired.append(req)
        self.stats["retired"] += 1

    # ------------------------------------------------------------- surface
    @property
    def retired(self) -> List[Request]:
        """Requests that finished entirely at the prefill role."""
        with self._lock:
            return list(self._retired)

    @property
    def idle(self) -> bool:
        return (not self._jobs and not self._queue
                and self.cr.active_count == 0)

    def metrics(self) -> ServeMetrics:
        out = summarize(self.retired)
        out.update(self.stats)
        out["bytes_shipped"] = self.bytes_shipped
        out.update(self.pool.metrics())
        return ServeMetrics.from_flat(out)

    def _log(self, kind: str, req_id: int, *rest: Any) -> None:
        if self._events is not None:
            self._events.append((kind, req_id) + rest)
        _trace_log(kind, req_id, rest, "prefill")


# ----------------------------------------------------------- decode role
class _Landing:
    """One request's blocks-in-flight state on the decode side."""

    __slots__ = ("req", "plen", "n_ship", "first", "installed", "resolved",
                 "recvs", "active", "aborted", "queued")

    def __init__(self, req: Request, plen: int, n_ship: int) -> None:
        self.req = req
        self.plen = plen
        self.n_ship = n_ship
        self.first: Optional[int] = None   # set by PrefillDone
        self.installed = 0                 # blocks written into the pool
        self.resolved = 0                  # block receives completed/cancelled
        self.recvs: List[Any] = []
        self.active = False                # footprint allocated, recvs posted
        self.aborted = False
        self.queued = False                # handed to the seat batcher


class DecodeWorker(ServeEngine):
    """A ``ServeEngine`` whose admission path is remote KV ingestion.

    Local prefill never runs here: requests arrive as a ``PrefillHeader``
    on the control channel, their KV pages land via per-block delivery
    continuations (``PagePool.import_page``, in place, so the decode or
    verify graph captured in ``ServeEngine.__init__`` reads them), and
    seating goes through ``_seat_slot`` — the same slot/step/retirement
    machinery as the colocated engine, so decode behavior (and tokens)
    are identical.

    The seat queue is a second ``Batcher``: landed requests admit into
    free slots in QoS order with past-deadline refusal, and its
    ``on_drop`` hook releases the already-landed pages of requests
    cancelled or expired while waiting.

    ``stream`` is the current stream at construction (on a CUDA device):
    the decode and verify graphs replay there, and every device op this
    role queues from a continuation goes there too.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *,
                 transport: Transport, rank: int, peer: int,
                 events: Optional[List[tuple]] = None,
                 **engine_kwargs: Any) -> None:
        engine_kwargs.setdefault("paged", True)
        super().__init__(cfg, params, **engine_kwargs)
        if not self.paged:
            raise ValueError("DecodeWorker requires paged mode")
        self.stream: Optional[torch.cuda.Stream] = \
            torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        self.transport = transport
        self.rank, self.peer = rank, peer
        self._events = events
        # standing control receive rides its own CR so its permanent
        # registration never blocks idle detection; block receives ride
        # cr_ingest and drain to zero with their landings
        self.cr_ctrl = self.engine.continue_init()
        self.cr_ingest = self.engine.continue_init()
        self._expected: Dict[int, Request] = {}
        self._landings: Dict[int, _Landing] = {}
        self._pending_landings: Deque[_Landing] = deque()
        self.seat_batcher = Batcher(self.engine, on_drop=self._drop_landed)
        self.ingest_stats = {"headers": 0, "blocks_installed": 0,
                             "blocks_discarded": 0, "blocks_drained": 0,
                             "remote_seated": 0, "aborts": 0,
                             "landings_deferred": 0}
        self._ctrl_op: Optional[Any] = None
        self._post_ctrl_recv()

    # ------------------------------------------------------------- intake
    def submit(self, request: Request) -> Request:
        raise RuntimeError(
            "the decode role receives work via transport ingestion; "
            "submit through the DisaggServer router")

    def expect(self, req: Request) -> None:
        """Control-plane registration: the router names the ``Request``
        object a forthcoming header refers to (the transport itself only
        ever carries ids and KV blocks)."""
        self._expected[req.req_id] = req

    # ----------------------------------------------------- control channel
    def _post_ctrl_recv(self) -> None:
        op = self.transport.irecv(self.rank, source=self.peer, tag=CTRL_TAG)
        self._ctrl_op = op
        self.engine.continue_when(op, self._on_ctrl, op, cr=self.cr_ctrl,
                                  flags=_FLAGS)

    def _on_ctrl(self, statuses, op) -> None:
        if op.state is OpState.CANCELLED:
            return                      # shutdown: don't re-arm
        msg = op.status.payload
        self._post_ctrl_recv()          # re-arm before processing
        if isinstance(msg, PrefillHeader):
            self._on_header(msg)
        elif isinstance(msg, PrefillDone):
            landing = self._landings.get(msg.req_id)
            if landing is not None:
                landing.first = int(msg.first_token)
                self._advance_landing(landing)
        elif isinstance(msg, PrefillAbort):
            self._on_abort(msg)

    def _on_header(self, msg: PrefillHeader) -> None:
        req = self._expected.pop(msg.req_id, None)
        if req is None:                 # router never announced it
            raise RuntimeError(f"header for unknown request {msg.req_id}")
        self.ingest_stats["headers"] += 1
        landing = _Landing(req, msg.plen, msg.n_ship)
        self._landings[msg.req_id] = landing
        if not self._try_activate(landing):
            self.ingest_stats["landings_deferred"] += 1
            self._pending_landings.append(landing)

    def _try_activate(self, landing: _Landing) -> bool:
        """Allocate the request's full decode footprint and post its
        block receives. False = pool can't cover it yet (backpressure:
        rendezvous block sends simply wait unmatched)."""
        req = landing.req
        n_pages = pages_for(landing.plen + req.max_new_tokens,
                            self.page_size)
        table = self.pool.alloc(n_pages)
        if table is None:
            return False
        req.page_ids = table
        tr = _obs.TRACE
        if tr is not None and tr.want(req.req_id):
            tr.evt(_obs_events.REQ_PAGES_ALLOC, req.req_id, "decode",
                   meta=len(table))
        landing.active = True
        for _ in range(landing.n_ship):
            rop = self.transport.irecv(self.rank, source=self.peer,
                                       tag=block_tag(req.req_id))
            landing.recvs.append(rop)
            self.engine.continue_when(rop, self._on_block, (landing, rop),
                                      cr=self.cr_ingest, flags=_FLAGS)
        return True

    # ------------------------------------------------------ block landing
    def _on_block(self, statuses, meta) -> None:
        landing, rop = meta
        landing.resolved += 1
        if rop.state is not OpState.CANCELLED:
            msg = rop.status.payload
            req = landing.req
            if landing.aborted or req.is_terminal:
                self.ingest_stats["blocks_discarded"] += 1
            else:
                # this may run inside the prefill role's isend, under its
                # stream: the install goes on this role's stream, and the
                # block's memory is claimed for it
                with torch.cuda.stream(self.stream):
                    take(msg, self.stream)
                    self.pool.import_page(req.page_ids[msg.index],
                                          {"k": msg.k, "v": msg.v})
                landing.installed += 1
                self.ingest_stats["blocks_installed"] += 1
                self._log("install", msg.req_id, msg.index)
        self._advance_landing(landing)

    def _advance_landing(self, landing: _Landing) -> None:
        req = landing.req
        if landing.queued:
            return                      # seat queue / slot machinery owns it
        if landing.aborted or req.is_terminal:
            # teardown completes once every posted receive resolved
            # (matched-and-discarded or cancelled)
            if landing.resolved == len(landing.recvs):
                self._release_pages(req)
                self._landings.pop(req.req_id, None)
            return
        if landing.first is not None and landing.installed == landing.n_ship:
            landing.queued = True
            # full prompt pages join the decode-side prefix index, so
            # future colocated-style affinity/reuse can find them
            self.pool.register_prefix(req.prompt, req.page_ids)
            self.seat_batcher.submit(req)
            self._log("landed", req.req_id)

    def _on_abort(self, msg: PrefillAbort) -> None:
        self.ingest_stats["aborts"] += 1
        # the request may have died before its header was ever sent
        self._expected.pop(msg.req_id, None)
        landing = self._landings.get(msg.req_id)
        if landing is None:
            return
        if landing.queued:
            return                      # done+abort never both arrive
        landing.aborted = True
        if not landing.active:
            # never allocated: just drain the blocks already in flight so
            # their (rendezvous) sends complete and nothing lingers in
            # the unexpected queue
            try:
                self._pending_landings.remove(landing)
            except ValueError:
                pass
            self._landings.pop(msg.req_id, None)
            for _ in range(msg.shipped):
                rop = self.transport.irecv(self.rank, source=self.peer,
                                           tag=block_tag(msg.req_id))
                self.engine.continue_when(rop, self._on_drain, rop,
                                          cr=self.cr_ingest, flags=_FLAGS)
            return
        # cancel still-posted receives; ones concurrently matching resolve
        # through _on_block (RecvOp.cancel is atomic complete-or-cancel)
        for rop in landing.recvs:
            if rop.state is OpState.PENDING:
                rop.cancel()
        self._advance_landing(landing)

    def _on_drain(self, statuses, rop) -> None:
        self.ingest_stats["blocks_drained"] += 1

    def _drop_landed(self, req: Request) -> None:
        """Seat-batcher ``on_drop``: a landed request was refused
        (cancelled or past-deadline while queued for a slot) — its pages
        are already allocated and must release here."""
        self._landings.pop(req.req_id, None)
        self._release_pages(req)

    # ------------------------------------------------------------ seating
    def _admit(self) -> int:
        # deferred landings first: pages freed by retirements may now
        # cover them (FIFO — the prefill role already ordered admission)
        while self._pending_landings:
            landing = self._pending_landings[0]
            if landing.req.is_terminal:
                self._pending_landings.popleft()
                self._landings.pop(landing.req.req_id, None)
                continue
            if not self._try_activate(landing):
                break
            self._pending_landings.popleft()
        free = self._free_slots()
        if not free:
            return 0
        admitted = 0
        for req in self.seat_batcher.admit(len(free)):
            landing = self._landings.pop(req.req_id, None)
            if landing is None:
                continue
            ctx = None
            if self.speculate:
                ctx = np.asarray(req.prompt, np.int32).reshape(-1).tolist()
                ctx.append(landing.first)
            # the first token goes up pinned and non-blocking, queued
            # behind the installs on this stream
            first = self._upload(np.asarray([landing.first], np.int32))
            self._seat_slot(free.pop(0), req, first, landing.plen, ctx=ctx)
            self.ingest_stats["remote_seated"] += 1
            self._log("seat", req.req_id)
            admitted += 1
        return admitted

    # ---------------------------------------------------------------- loop
    def step(self) -> bool:
        with torch.cuda.stream(self.stream):
            return super().step()

    def _on_verify_done(self, statuses, meta) -> None:
        # it queues the next input tokens; it may run inside the prefill
        # role's transport call, under that role's stream
        with torch.cuda.stream(self.stream):
            super()._on_verify_done(statuses, meta)

    # ------------------------------------------------------------- surface
    @property
    def idle(self) -> bool:
        return (super().idle
                and not self._landings and not self._pending_landings
                and self.seat_batcher.queued == 0
                and self.seat_batcher.cr.active_count == 0
                and self.cr_ingest.active_count == 0)

    def shutdown_ingest(self) -> None:
        """Cancel the standing control receive (facade shutdown)."""
        if self._ctrl_op is not None:
            self._ctrl_op.cancel()

    def _metrics_flat(self) -> dict:
        out = super()._metrics_flat()
        out.update(self.ingest_stats)
        return out

    def _log(self, kind: str, req_id: int, *rest: Any) -> None:
        if self._events is not None:
            self._events.append((kind, req_id) + rest)
        _trace_log(kind, req_id, rest, "decode")


# --------------------------------------------------------------- facade
class DisaggServer:
    """Router + facade over a prefill role and a decode role connected by
    an in-process ``Transport`` (2 ranks, one shared continuation
    engine, one driver thread), on ``device`` (default ``"cuda"``;
    ``"cpu"`` runs the kernels' plain versions).

    Exposes the ``ServeEngine`` surface — ``submit`` / ``step`` /
    ``run`` / ``close_intake`` / ``idle`` / ``metrics`` / ``retired`` /
    ``shutdown`` plus a ``batcher`` attribute — so ``ServeClient`` and
    the token-stream API work over it unchanged. ``events`` records the
    handoff lifecycle (``header``/``ship``/``install``/``prefill_done``/
    ``landed``/``seat``/``abort``/``prefill_released``) in driver-thread
    order; tests assert per-block pipelining on it.

    Construction knobs beyond ``ServeEngine``'s: ``chunk_pages`` (prompt
    pages per prefill chunk — smaller chunks ship earlier),
    ``prefill_pages`` (staging pool size, default twice one max request),
    ``prefill_jobs`` (concurrent prompts at the prefill role), and the
    transport's ``latency_s`` / ``eager_threshold`` for experiments.
    Construct it on the thread that owns the card (the decode role
    captures its step graph then).
    """

    def __init__(self, cfg: ModelConfig, params: Any, *,
                 device: Any = "cuda",
                 max_batch: int = 4,
                 max_cache_len: int = 256,
                 max_inflight: int = 2,
                 engine: Optional[Engine] = None,
                 scheduler: Union[str, Scheduler] = "fifo",
                 page_size: int = 16,
                 total_pages: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 speculate: int = 0,
                 drafter: Optional[Drafter] = None,
                 fused: Optional[bool] = None,
                 chunk_pages: int = 1,
                 prefill_pages: Optional[int] = None,
                 prefill_jobs: int = 2,
                 latency_s: float = 0.0,
                 eager_threshold: int = 4096) -> None:
        if not paged_supported(cfg):
            raise ValueError("disaggregated serving requires a "
                             "paged-cache-capable model config")
        device = resolve_device(device)
        self._own_engine = engine is None
        self.engine = engine if engine is not None else \
            Engine(scheduler=scheduler)
        self.transport = Transport(2, engine=self.engine,
                                   latency_s=latency_s,
                                   eager_threshold=eager_threshold)
        self.events: List[tuple] = []
        self.decode = DecodeWorker(
            cfg, params, transport=self.transport, rank=DECODE_RANK,
            peer=PREFILL_RANK, events=self.events, engine=self.engine,
            device=device, max_batch=max_batch, max_cache_len=max_cache_len,
            max_inflight=max_inflight, paged=True, page_size=page_size,
            total_pages=total_pages, max_seq_len=max_seq_len,
            speculate=speculate, drafter=drafter, fused=fused)
        if prefill_pages is None:
            prefill_pages = 2 * pages_for(self.decode.max_seq_len,
                                          page_size)
        self.prefill = PrefillWorker(
            cfg, params, engine=self.engine, transport=self.transport,
            rank=PREFILL_RANK, peer=DECODE_RANK, page_size=page_size,
            total_pages=prefill_pages,
            max_prompt_len=self.decode.max_seq_len,
            chunk_pages=chunk_pages, max_jobs=prefill_jobs,
            events=self.events, device=device)
        self.batcher = Batcher(self.engine)      # router intake

    # ------------------------------------------------------------- clients
    def submit(self, request: Request) -> Request:
        plen = int(np.asarray(request.prompt).reshape(-1).shape[0])
        total = plen + request.max_new_tokens
        if total > self.decode.max_seq_len:
            raise ValueError(f"request needs {total} tokens > max_seq_len="
                             f"{self.decode.max_seq_len}")
        if pages_for(total, self.decode.page_size) \
                > self.decode.pool.total_pages:
            raise ValueError("request needs more pages than the decode "
                             f"pool holds ({self.decode.pool.total_pages})")
        if pages_for(plen, self.prefill.page_size) \
                > self.prefill.pool.total_pages:
            raise ValueError("prompt needs more pages than the prefill "
                             f"pool holds ({self.prefill.pool.total_pages})")
        tr = _obs.TRACE
        if tr is not None and tr.want(request.req_id):
            tr.evt(_obs_events.REQ_SUBMIT, request.req_id, "serve")
        return self.batcher.submit(request)

    def close_intake(self) -> None:
        self.batcher.close()

    @property
    def retired(self) -> List[Request]:
        return self.decode.retired + self.prefill.retired

    # ----------------------------------------------------------------- loop
    def _route(self) -> int:
        """Admit intake in QoS order and hand requests to the prefill
        role; the decode role is told to expect each one first (the
        header may race ahead on the control channel otherwise)."""
        reqs = self.batcher.admit(self.prefill.capacity)
        tr = _obs.TRACE
        for req in reqs:
            if tr is not None and tr.want(req.req_id):
                tr.evt(_obs_events.REQ_ADMIT, req.req_id, "serve",
                       ts=req.arrival_time,
                       dur=tr.now() - req.arrival_time)
            if req.max_new_tokens > 1:
                self.decode.expect(req)
            self.prefill.start(req)
        return len(reqs)

    def step(self) -> bool:
        routed = self._route()
        prefilled = self.prefill.step()
        decoded = self.decode.step()     # also ticks the shared engine
        return bool(routed) or prefilled or decoded

    @property
    def idle(self) -> bool:
        return (not self._pending_intake() and self.prefill.idle
                and self.decode.idle)

    def _pending_intake(self) -> bool:
        return bool(self.batcher.queued or self.batcher.cr.active_count)

    def run(self, timeout: Optional[float] = None,
            idle_sleep: float = 5e-5, until=None) -> List[Request]:
        deadline = None if timeout is None else time.monotonic() + timeout
        done = until if until is not None else \
            (lambda: self.batcher.closed and self.idle)
        while not done():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    "disagg serve loop timed out: "
                    f"queued={self.batcher.queued} "
                    f"prefill_jobs={len(self.prefill._jobs)} "
                    f"landings={len(self.decode._landings)} "
                    f"active={self.decode.active}")
            if not self.step():
                time.sleep(idle_sleep)
        return self.retired

    # -------------------------------------------------------------- metrics
    def metrics(self) -> ServeMetrics:
        out = summarize(self.retired)
        out["disaggregated"] = True
        out["retired"] = (self.decode.stats["retired"]
                          + self.prefill.stats["retired"])
        # headline residency = the decode pool (long-lived KV); per-role
        # detail stays nested
        out["pages_in_use"] = self.decode.pool.pages_in_use
        out["total_pages"] = self.decode.pool.total_pages
        out["decode"] = self.decode.metrics()
        out["prefill"] = self.prefill.metrics()
        st = self.transport.stats()
        out["transport"] = st
        out.update(transport_fields(st))
        shipped = self.prefill.stats["blocks_shipped"]
        jobs = self.prefill.stats["jobs"]
        out["blocks_shipped"] = shipped
        out["bytes_shipped"] = self.prefill.bytes_shipped
        out["bytes_shipped_per_request"] = \
            self.prefill.bytes_shipped / jobs if jobs else 0.0
        return ServeMetrics.from_flat(out)

    def shutdown(self) -> None:
        self.batcher.close()
        self.decode.shutdown_ingest()
        self.decode.shutdown()           # closes its (unused) intake
        self.transport.shutdown()
        if self._own_engine:
            self.engine.shutdown()


def serve_requests_disagg(cfg: ModelConfig, params: Any,
                          requests: List[Request], *,
                          timeout: float = 300.0,
                          **kwargs: Any) -> List[Request]:
    """Convenience: serve a fixed request list through a disaggregated
    server to completion (mirror of ``serve.engine.serve_requests``)."""
    srv = DisaggServer(cfg, params, **kwargs)
    try:
        for r in requests:
            srv.submit(r)
        srv.close_intake()
        srv.run(timeout=timeout)
    finally:
        srv.shutdown()
    return list(requests)

"""Continuation-driven continuous-batching decode engine.

Counterpart of ``repro/serve/engine.py`` in its two memory modes:

* *paged* (default where ``paged_supported``: the dense and MoE
  families) — paged steps over a shared ``PagePool`` behind per-slot page
  tables: fused (default: the paged kernel walks the tables) or, with
  ``fused=False``, unfused (each slot's pages gathered into a contiguous
  view for the dense decode, the written pages copied back, the verify
  step's write targets built on the host by ``PagePool.write_table``);
* *dense* (``paged=False``, and automatically where paged caching is not
  supported: the SSM and hybrid families and sliding-window configs) — a
  layer-stacked per-slot cache with the slots as its batch: the SSM state
  of constant size (mamba2), a KV cache of ``max_cache_len`` positions per
  slot, a ring of ``window`` slots for a sliding-window config whose
  ``max_cache_len`` reaches the window (h2o-danube3), or a hybrid's SSM
  state beside its shared-block sites' KV (zamba2). Each slot decodes at
  its own position, read from a static device buffer.

The decode loop keeps a fixed set of *slots*, each holding one in-flight
sequence:

* **admission** — requests queue on the ``Batcher``'s ``poll_only +
  enqueue_complete`` CR (paper §3.5) and are admitted into free slots at
  step boundaries. Paged: a cold prompt is prefilled (flash kernel) and
  its pages copied into the pool, a prompt that starts with resident
  pages runs only its tail through the paged suffix step (suffix
  prefill). Dense: a batch-1 prefill at the prompt's exact length (SSD
  or flash kernel), written straight into the slot's rows.
* **decode** — one step (paged, or the batched dense decode)
  advances every occupied slot by one token. The step's next-token
  tensor is wrapped in a ``TensorOp`` whose continuation delivers the
  tokens and retires finished slots (releasing their pages) when the
  device work has *actually* finished. The host loop never blocks on
  device work.
* **speculation** (``speculate=K``, paged mode) — each iteration is a
  draft/verify pair: a host-side ``Drafter`` (n-gram prompt lookup by
  default) guesses up to K tokens per slot, and one verify step scores
  all K+1 window rows, accepting the longest matching prefix. The accept
  bookkeeping runs in the verify step's continuation, so the tokens equal
  non-speculative greedy decode.

Each decode or verify step is one ``StepGraph`` (``serve.graphs``), the
counterpart of the reference's ``jax.jit``: on a CUDA device it is
captured as a CUDA graph when the engine is constructed (the pool or the
slot state and every static buffer are allocated there, before any slot
is seated) and replayed as one launch a step; on the CPU it runs eagerly
on the same buffers. Prefill and suffix prefill run eagerly.

What keeps the loop from blocking, in PyTorch terms:

* every device op goes on one stream, so the in-place pool updates, the
  prefill scatter and every later read are ordered by the stream itself
  (this replaces JAX's data dependencies and donation);
* host data goes up with ``pin_memory()`` + ``non_blocking=True`` (a
  blocking upload would wait for every step in flight), into the step
  graphs' static buffers, queued ahead of the replay that reads them;
* a step's outputs come down the same way, into a fresh pinned host
  tensor per step in flight, started right after the step and before the
  op's event is recorded; continuations read only that host copy, never
  a CUDA tensor (``int()``/``.item()``/``.cpu()`` there would sync the
  stream behind the next step already queued).

The engine refuses the audio enc-dec (whisper) and the VLM (internvl2)
at construction, as the reference's refuses the first: both serve
through ``serve.steps``.
"""
from __future__ import annotations

import threading
import time
from typing import (Any, List, NamedTuple, Optional, Sequence, Set, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core import (ContinueFlags, Engine, Promise, Scheduler,
                              TensorOp)
from repro_torch.models import lm
from repro_torch.models.common import AUDIO, VLM, ModelConfig
from repro_torch.obs import events as _obs_events
from repro_torch.obs import tracer as _obs
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.drafter import Drafter, NgramDrafter
from repro_torch.serve.graphs import StepGraph
from repro_torch.serve.kv_cache import PagePool, paged_supported, pages_for
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.request import Request, RequestState, summarize
from repro_torch.serve.steps import (make_batched_decode_step,
                                     make_fused_paged_decode_step,
                                     make_fused_paged_suffix_step,
                                     make_fused_paged_verify_step,
                                     make_paged_decode_step,
                                     make_paged_suffix_step,
                                     make_paged_verify_step,
                                     make_prefill_scatter, make_prefill_step)
from repro_torch.util import resolve_device

# every step/prefill registration: never take the immediate-completion
# fast path, so bookkeeping always runs through the continuation machinery
# even when the device raced ahead
_STEP_FLAGS = ContinueFlags(enqueue_complete=True)
# steps carrying priority>0 requests additionally jump the scheduler's
# ready queue; cached per level, bounded (priorities are caller ints)
_PRIO_FLAGS: dict = {}
_PRIO_FLAGS_MAX = 64


def _step_flags(priority: int) -> ContinueFlags:
    if priority <= 0:
        return _STEP_FLAGS
    flags = _PRIO_FLAGS.get(priority)
    if flags is None:
        flags = ContinueFlags(enqueue_complete=True, priority=priority)
        if len(_PRIO_FLAGS) < _PRIO_FLAGS_MAX:
            _PRIO_FLAGS[priority] = flags
    return flags


class _DeviceTiming(NamedTuple):
    """A pair of CUDA timing events around work on the stream, with the
    host's dispatch stamp and the ``meta`` of the ``dev.*`` event."""
    ts: float
    meta: Any
    start: Any
    end: Any


class ServeEngine:
    """Continuous-batching engine over ``max_batch`` decode slots.

    Single-consumer: exactly one thread drives ``step()``/``run()``; any
    thread may ``submit()``. ``params`` must live on ``device`` (default
    ``"cuda"``; ``"cpu"`` runs the kernels' plain versions).

    ``paged`` defaults to ``paged_supported(cfg)``. Paged knobs:
    ``page_size`` tokens per KV page, ``max_seq_len`` (prompt + generation
    bound per request, default ``max_cache_len``), ``total_pages`` in the
    pool (default ``max_batch * ceil(max_seq_len / page_size)``).

    Speculative knobs (paged only): ``speculate=K`` runs a verify step
    scoring up to K drafts + 1 real token per slot per iteration;
    ``drafter`` plugs any ``serve.drafter.Drafter`` (default: n-gram
    prompt lookup). Requests may lower their own K or opt out
    (``GenerationConfig.speculate``).

    On a CUDA device the constructor captures the decode (or verify) step
    as a CUDA graph; construct the engine on the thread that owns the
    device's work, with no other capture under way. ``step()`` may then
    run on another thread (``ServeClient``'s loop).
    """

    def __init__(self, cfg: ModelConfig, params: Any, *,
                 device: Any = "cuda",
                 max_batch: int = 4,
                 max_cache_len: int = 256,
                 max_inflight: int = 2,
                 engine: Optional[Engine] = None,
                 scheduler: Union[str, Scheduler] = "fifo",
                 paged: Optional[bool] = None,
                 page_size: int = 16,
                 total_pages: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 speculate: int = 0,
                 drafter: Optional[Drafter] = None,
                 fused: Optional[bool] = None) -> None:
        if cfg.family == AUDIO:
            raise NotImplementedError(
                "ServeEngine drives token-in/token-out LM decode; audio "
                "enc-dec serving still goes through serve.steps directly")
        if cfg.family == VLM:
            raise NotImplementedError(
                f"ServeEngine takes token prompts only, and {cfg.name} is a "
                "VLM whose prefill needs image patches: serve it through "
                "serve.steps (make_prefill_step with batch['patches'], then "
                "make_decode_step at n_patches + S)")
        lm.require_ported(cfg)
        if paged is None:
            paged = paged_supported(cfg)
        elif paged and not paged_supported(cfg):
            raise ValueError(
                f"paged KV cache unsupported for {cfg.name!r} "
                "(needs dense/MoE family, scan_layers, no sliding window)")
        if speculate and not paged:
            raise ValueError(
                "speculative decoding runs through the paged verify step; "
                "speculate > 0 requires paged=True")
        if fused and not paged:
            raise ValueError("fused paged-attention steps require paged=True")
        self.device = resolve_device(device)
        emb = params["embed"]["tokens"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self._layers = lm.layer_views(params)
        self.max_batch = int(max_batch)
        self.max_cache_len = int(max_cache_len)
        self.max_inflight = max(1, int(max_inflight))
        self.paged = bool(paged)
        self.fused = bool(fused) if fused is not None else self.paged
        self.speculate = max(0, int(speculate))
        self.drafter = drafter if drafter is not None else NgramDrafter()
        self._own_engine = engine is None
        self.engine = engine if engine is not None else \
            Engine(scheduler=scheduler)
        self.batcher = Batcher(self.engine)
        self.cr_steps = self.engine.continue_init()

        S, K = self.max_batch, self.speculate
        i32 = dict(dtype=torch.int32, device=self.device)
        # static step inputs, written in place and never rebound: the next
        # input token of each slot, and one buffer holding the positions
        # (and, paged, the n_valid and drafts; unfused verify, the write
        # tables) of a step, uploaded in one copy
        self._tokens = torch.zeros((S, 1, 1), **i32)
        # pages an unfused verify window writes (the write tables' width)
        self._verify_pages = 1 + pages_for(K, page_size) \
            if K and self.paged and not self.fused else 0
        self._meta = torch.zeros(2 * S + S * K + S * self._verify_pages,
                                 **i32)
        self.pool: Optional[PagePool] = None
        self._cache: Optional[dict] = None
        # dense mode: the most tokens (prompt + new) a request may hold
        self._dense_bound: Optional[int] = None
        # dense mode with a KV cache (dense, hybrid): reads positions
        self._dense_kv = False
        self._decode_graph: Optional[StepGraph] = None
        self._verify_graph: Optional[StepGraph] = None
        if self.paged:
            self.page_size = int(page_size)
            self.max_seq_len = int(max_seq_len or max_cache_len)
            self.max_pages = pages_for(self.max_seq_len, self.page_size)
            # a verify window starting on a request's last page may reach
            # past its footprint: the slack entries name the null page
            self._spec_pad = pages_for(K, self.page_size) if K else 0
            self._table_pages = self.max_pages + self._spec_pad
            n_pool = int(total_pages) if total_pages is not None \
                else S * self.max_pages
            self.pool = PagePool(cfg, n_pool, self.page_size,
                                 device=self.device)
            self.pool.ensure_arrays()
            self._tables = np.full((S, self._table_pages),
                                   self.pool.null_page, np.int32)
            # device copy of _tables, re-uploaded in place (non-blocking)
            # only when a placement or eviction changed a row since the
            # last dispatch
            self._tables_dev = torch.tensor(self._tables, device=self.device)
            self._tables_dirty = False
            self._scatter_fn = make_prefill_scatter(cfg, self.page_size)
            # every n_valid is 0 until a dispatch: the warm-up of a capture
            # writes no page. The unfused steps write every slot, each
            # through a table (and, verify, write tables) naming only the
            # null page until then
            if self.fused:
                self._decode_fn = make_fused_paged_decode_step(
                    cfg, self.page_size, self._layers)
                self._suffix_fn = make_fused_paged_suffix_step(
                    cfg, self.page_size, self._layers)
                if K:
                    self._verify_fn = make_fused_paged_verify_step(
                        cfg, self.page_size, K, self._layers)
            else:
                self._decode_fn = make_paged_decode_step(
                    cfg, self.page_size, return_tokens=True,
                    layers=self._layers)
                self._suffix_fn = make_paged_suffix_step(
                    cfg, self.page_size, self._layers)
                if K:
                    self._verify_fn = make_paged_verify_step(
                        cfg, self.page_size, K, self._layers)
                    self._meta[2 * S + S * K:] = self.pool.null_page
            if K:
                self._verify_graph = StepGraph(self._verify_step,
                                               self.device)
            else:
                self._decode_graph = StepGraph(self._paged_step, self.device)
        else:
            # dense mode: layer-stacked caches, the S slots as their batch;
            # the warm-up steps every slot's rows, which hold nothing yet.
            # A KV cache bounds a request at its length, unless it is a
            # whole sliding window (a ring that never runs out)
            self._cache = lm.init_cache(cfg, S, self.max_cache_len,
                                        device=self.device)
            self._dense_kv = "k" in self._cache
            if self._dense_kv:
                cache_len = self._cache["k"].shape[2]
                if not (cfg.window and cache_len >= cfg.window):
                    self._dense_bound = cache_len
            self._decode_fn = make_batched_decode_step(cfg, self._layers)
            self._decode_graph = StepGraph(self._dense_step, self.device)

        # -- slot state (loop thread only) --
        self._slots: List[Optional[Request]] = [None] * S
        self._draining: Set[int] = set()      # token budget met, step in flight
        self._verifying: Set[int] = set()     # verify step in flight
        self._pos = np.zeros(S, np.int32)     # next write position per slot
        # speculative: per-slot host context (prompt + emitted tokens),
        # appended by the prefill/verify continuations as device steps
        # complete; what the drafter matches against
        self._ctx: List[Optional[List[int]]] = [None] * S
        self._inflight = 0                    # dispatched, not-yet-complete steps
        # (start, end) CUDA timing events free for reuse; filled only
        # while tracing on a card, by the ``dev.*`` continuations
        self._timing_pool: List[Tuple[Any, Any]] = []
        self._stalled_at: Optional[int] = None  # pages_in_use at last deferral
        self._retired: List[Request] = []
        self._lock = threading.Lock()         # guards _retired for readers
        self.stats = {"steps": 0, "prefills": 0, "retired": 0,
                      "slot_steps": 0, "padded_steps": 0, "cancelled": 0,
                      "suffix_steps": 0, "suffix_tokens": 0, "deferred": 0,
                      "max_active": 0, "verify_steps": 0, "spec_tokens": 0,
                      "draft_proposed": 0, "draft_accepted": 0,
                      "stopped": 0, "expired": 0,
                      # host seconds spent enqueueing decode (or verify)
                      # steps
                      "dispatch_s": 0.0}

    # ------------------------------------------------------------- clients
    def submit(self, request: Request) -> Request:
        """Thread-safe request intake (delegates to the Batcher CR)."""
        if self.paged:
            plen = int(np.asarray(request.prompt).reshape(-1).shape[0])
            total = plen + request.max_new_tokens
            if total > self.max_seq_len:
                raise ValueError(f"request needs {total} tokens > "
                                 f"max_seq_len={self.max_seq_len}")
            if pages_for(total, self.page_size) > self.pool.total_pages:
                raise ValueError(f"request needs more pages than the pool "
                                 f"holds ({self.pool.total_pages})")
        elif self._dense_bound is not None:
            plen = int(np.asarray(request.prompt).reshape(-1).shape[0])
            total = plen + request.max_new_tokens
            if total > self._dense_bound:
                raise ValueError(f"request needs {total} tokens > the dense "
                                 f"cache's {self._dense_bound} positions")
        tr = _obs.TRACE
        if tr is not None and tr.want(request.req_id):
            tr.evt(_obs_events.REQ_SUBMIT, request.req_id, "engine")
        return self.batcher.submit(request)

    def submit_async(self, request: Request) -> Promise:
        """Submit and get an awaitable ``Promise`` resolving with the
        generated tokens at retirement."""
        self.submit(request)
        return self.engine.wrap(request)

    def close_intake(self) -> None:
        self.batcher.close()

    @property
    def retired(self) -> List[Request]:
        with self._lock:
            return list(self._retired)

    # ------------------------------------------------------- host <-> device
    def _upload(self, a: np.ndarray,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Host ints to the device without waiting for the stream: copied
        into pinned memory, then a non-blocking copy into ``out`` (a static
        buffer of ``a``'s size) or a new tensor. The caching host allocator
        keeps that pinned block until the copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.int32))
        if self.device.type != "cpu":
            t = t.pin_memory()
        if out is None:
            return t.to(self.device, non_blocking=True, copy=True)
        return out.copy_(t.view(out.shape), non_blocking=True)

    def _download(self, t: torch.Tensor) -> torch.Tensor:
        """Start a device→host copy of a step's output into a new (pinned)
        host tensor; valid once the TensorOp created after this call
        completes. A step graph's outputs are overwritten by its next
        replay, so each step in flight keeps its own copy."""
        if self.device.type == "cpu":
            return t.clone()
        return t.to("cpu", non_blocking=True)

    # ------------------------------------------------------------ step graphs
    def _paged_step(self) -> torch.Tensor:
        """The paged decode over the static buffers (the unfused step reads
        no n_valid); the next tokens become the next inputs in place."""
        S = self.max_batch
        args = (self.params, self.pool.arrays, self._tokens, self._meta[:S],
                self._tables_dev)
        if self.fused:
            args += (self._meta[S:2 * S],)
        nxt, _ = self._decode_fn(*args)
        self._tokens.copy_(nxt[..., None])
        return nxt

    def _dense_step(self) -> torch.Tensor:
        """The dense-mode decode of every slot, each at its position in
        the static buffer (a cache without KV, the SSM family's, reads
        none); the next tokens become the next inputs in place."""
        positions = self._meta[:self.max_batch] if self._dense_kv else None
        nxt, _ = self._decode_fn(self.params, self._cache, self._tokens,
                                 positions)
        self._tokens.copy_(nxt[..., None])
        return nxt

    def _verify_step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The paged verify over the static buffers; the unfused step takes
        the write tables and each slot's draft count (n_valid - 1, 0 when
        idle) besides. The next input tokens are set by the verify
        continuation, once the accepted runs are known on the host."""
        S, K = self.max_batch, self.speculate
        drafts = self._meta[2 * S:2 * S + S * K]
        tokens = torch.cat([self._tokens, drafts.view(S, 1, K)], dim=2)
        args = (self.params, self.pool.arrays, tokens, self._meta[:S],
                self._tables_dev)
        n_valid = self._meta[S:2 * S]
        if self.fused:
            args += (n_valid,)
        else:
            args += (self._meta[2 * S + S * K:].view(S, self._verify_pages),
                     torch.clamp(n_valid - 1, min=0))
        emitted, accepts, _ = self._verify_fn(*args)
        return emitted, accepts

    # ---------------------------------------------------------- slot state
    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    @property
    def active(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    # ------------------------------------------------------------ admission
    def _admit(self) -> int:
        # after a capacity deferral, admission can only succeed once a
        # retirement or cancellation has returned pages to the pool
        if self._stalled_at is not None:
            if self.pool.pages_in_use >= self._stalled_at:
                return 0
            self._stalled_at = None
        free = self._free_slots()
        reqs = self.batcher.admit(len(free))
        admitted = 0
        for i, req in enumerate(reqs):
            if not self._place(req, free):
                # the pool can't cover the request's worst case yet: return
                # it (and everything behind it, in order) to the queue head
                self.stats["deferred"] += 1
                self._stalled_at = self.pool.pages_in_use
                for r in reversed(reqs[i:]):
                    self.batcher.requeue(r)
                break
            admitted += 1
        return admitted

    def _place(self, req: Request, free: List[int]) -> bool:
        """Prefill ``req`` and seat it in a slot. False = defer (paged
        capacity); True = placed (or answered outright by prefill)."""
        prompt_np = np.asarray(req.prompt, np.int32).reshape(1, -1)
        plen = prompt_np.shape[1]
        tr = _obs.TRACE
        t0 = dev = None
        if tr is not None:
            t_place = tr.now()
            if tr.want(req.req_id):
                t0 = t_place
                tr.evt(_obs_events.REQ_ADMIT, req.req_id, "engine",
                       ts=req.arrival_time, dur=t0 - req.arrival_time)
            dev = self._timing_events(t_place, plen)
        # single-token request: prefill answers it outright; it never
        # occupies a decode slot nor any pages
        retire_now = req.max_new_tokens == 1
        slot = None
        if retire_now:
            logits, _ = make_prefill_step(self.cfg, plen)(
                self.params, {"tokens": self._upload(prompt_np)})
            first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        elif self.paged:
            first = self._prefill_paged(req, prompt_np)
            if first is None:
                if dev is not None:
                    self._timing_pool.append((dev.start, dev.end))
                return False
            slot = free.pop(0)
        else:
            slot = free.pop(0)
            first = self._prefill_dense(slot, prompt_np)
        if dev is not None:
            dev.end.record()
        first_host = self._download(first)
        req.push_device_token(first_host[0])
        self.stats["prefills"] += 1
        if not retire_now:
            # the drafter's host context: the prompt now, the first token
            # in the prefill continuation, each accepted run in a verify's
            ctx = np.asarray(req.prompt, np.int32).reshape(-1).tolist() \
                if self.speculate else None
            self._seat_slot(slot, req, first, plen, ctx)
        self.engine.continue_when(
            TensorOp(first, payload=first_host), self._on_prefill_done,
            (req, retire_now, slot, first_host, t0, dev), cr=self.cr_steps,
            flags=_step_flags(req.priority))
        if tr is not None:
            tr.evt(_obs_events.ENGINE_PREFILL, req.req_id, "engine",
                   ts=t_place, dur=tr.now() - t_place, meta=plen)
        return True

    def _timing_events(self, ts: float, meta: Any
                       ) -> Optional[_DeviceTiming]:
        """While tracing, on a card: a pair of CUDA timing events whose
        start is recorded on the stream now and whose ``end`` the caller
        records after the work; None on the CPU. Pairs come from
        ``_timing_pool`` where one is free, so once the pool holds as many
        as are in flight, no event is made inside a timed interval."""
        if self.device.type != "cuda":
            return None
        try:
            start, end = self._timing_pool.pop()
        except IndexError:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        start.record()
        return _DeviceTiming(ts, meta, start, end)

    def _device_span(self, kind: str, rid: int, dev: _DeviceTiming) -> None:
        """A ``dev.*`` event from a pair of ``_timing_events`` the work's
        continuation found complete: ``dur`` is the device clock's seconds
        between them. The pair goes back to the pool."""
        tr = _obs.TRACE
        if tr is not None:
            tr.evt(kind, rid, "engine", ts=dev.ts,
                   dur=dev.start.elapsed_time(dev.end) * 1e-3, meta=dev.meta)
        self._timing_pool.append((dev.start, dev.end))

    def _seat_slot(self, slot: int, req: Request, token0: torch.Tensor,
                   plen: int, ctx: Optional[List[int]] = None) -> None:
        """Seat a prefilled request into decode slot ``slot``: its page
        table row (paged), next input token (device (1,) tensor, written in
        place behind the prefill on the stream) and position."""
        tr = _obs.TRACE
        if tr is not None and tr.want(req.req_id):
            tr.evt(_obs_events.REQ_SEAT, req.req_id, "engine", meta=slot)
        if self.paged:
            self._tables[slot, :] = self.pool.null_page
            self._tables[slot, :len(req.page_ids)] = req.page_ids
            self._tables_dirty = True
        self._tokens[slot, 0, 0] = token0[0]
        self._pos[slot] = plen
        self._slots[slot] = req
        self._ctx[slot] = ctx

    def _prefill_dense(self, slot: int,
                       prompt_np: np.ndarray) -> torch.Tensor:
        """Batch-1 prefill at the prompt's exact length, writing its state
        straight into ``slot``'s rows of the stacked cache (views; the
        writes queue on the stream behind any step still reading the slot's
        old rows). Returns the first-token tensor (1,) int32 on the
        device."""
        views = {name: t[:, slot:slot + 1] for name, t in self._cache.items()}
        logits, _ = lm.lm_prefill(
            self.params, {"tokens": self._upload(prompt_np)}, self.cfg, views)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    def _prefill_paged(self, req: Request,
                       prompt_np: np.ndarray) -> Optional[torch.Tensor]:
        """Allocate pages, reuse any cached prefix, fill the prompt KV.

        Returns the first-token tensor (1,) int32 on the device, or None
        when the pool can't cover the worst-case footprint (defer —
        nothing was allocated)."""
        pool, ps = self.pool, self.page_size
        plen = prompt_np.shape[1]
        n_pages = pages_for(plen + req.max_new_tokens, ps)
        shared = pool.match_prefix(req.prompt)
        owned = pool.alloc(n_pages - len(shared))
        if owned is None:
            return None
        for p in shared:
            pool.retain(p)
        table = shared + owned
        req.page_ids = table
        req.shared_prefix_tokens = len(shared) * ps
        tr = _obs.TRACE
        if tr is not None and tr.want(req.req_id):
            tr.evt(_obs_events.REQ_PAGES_ALLOC, req.req_id, "engine",
                   meta=len(table))

        if shared:
            # prefix hit: shared pages already hold positions [0, m*ps);
            # one suffix-prefill call runs the remaining prompt tokens
            # against them. The tail is padded to a page multiple; the
            # fused kernel writes rows [0, tail) only, all into owned
            # pages; the unfused step copies back owned pages only (its
            # scatter table names the null page for shared ones and the
            # padding), and the pad rows' writes past the prompt are
            # overwritten by the decode at those positions before any row
            # attends to them.
            pool.stats["prefix_hits"] += 1
            pool.stats["prefix_tokens_reused"] += len(shared) * ps
            start = len(shared) * ps
            tail = plen - start
            padded = pages_for(tail, ps) * ps
            T = self._table_pages
            if self.fused:
                # one upload for all operands: tokens | position | table | n
                ops = np.zeros(padded + 2 + T, np.int32)
                ops[:tail] = prompt_np[0, start:]
                ops[padded] = start
                ops[padded + 1] = tail
                ops[padded + 2:] = self.pool.null_page
                ops[padded + 2:padded + 2 + len(table)] = table
                dev = self._upload(ops)
                logits, _ = self._suffix_fn(
                    self.params, pool.arrays, dev[:padded].view(1, padded),
                    dev[padded:padded + 1], dev[padded + 2:].view(1, -1),
                    dev[padded + 1:padded + 2])
            else:
                # one upload: tokens | gather table | scatter table
                ops = np.full(padded + 2 * T, self.pool.null_page, np.int32)
                ops[:padded] = 0
                ops[:tail] = prompt_np[0, start:]
                ops[padded:padded + len(table)] = table
                ops[padded + T + len(shared):padded + T + len(table)] = \
                    table[len(shared):]
                dev = self._upload(ops)
                logits, _ = self._suffix_fn(
                    self.params, pool.arrays, dev[:padded].view(1, padded),
                    start, dev[padded:padded + T], dev[padded + T:])
            self.stats["suffix_steps"] += 1
            self.stats["suffix_tokens"] += tail
            first = torch.argmax(logits[:, tail - 1], dim=-1)
        else:
            # cold: dense prefill over the prompt's pages, then one copy of
            # those pages into the pool
            n_prompt = pages_for(plen, ps)
            ops = np.concatenate([prompt_np[0],
                                  np.asarray(table[:n_prompt], np.int32)])
            dev = self._upload(ops)
            logits, cache = make_prefill_step(self.cfg, n_prompt * ps)(
                self.params, {"tokens": dev[:plen].view(1, plen)})
            first = torch.argmax(logits[:, -1], dim=-1)
            self._scatter_fn(pool.arrays, cache, dev[plen:].long())
        pool.register_prefix(req.prompt, table)
        return first.to(torch.int32)

    def _refresh_tables(self) -> None:
        """Bring the static device copy of the page tables up to date,
        without blocking, after a placement or eviction changed a row."""
        if self._tables_dirty:
            self._upload(self._tables, out=self._tables_dev)
            self._tables_dirty = False

    def _on_prefill_done(self, statuses, meta) -> None:
        req, retire_now, slot, first_host, t0, dev = meta
        if dev is not None:
            self._device_span(_obs_events.DEV_PREFILL, req.req_id, dev)
        if t0 is not None:
            tr = _obs.TRACE
            if tr is not None:
                tr.evt(_obs_events.REQ_PREFILL, req.req_id, "engine",
                       ts=t0, dur=tr.now() - t0)
        req.on_first_token()
        # the host copy is complete by continuation time: reading it never
        # touches the device
        finished = req.deliver([int(first_host[0])])
        if retire_now:
            self._retire(req, stopped=finished == "stop")
            return
        # the slot may have been evicted (cancel) and reseated since
        if (slot is not None and self._ctx[slot] is not None
                and self._slots[slot] is req):
            self._ctx[slot].append(int(first_host[0]))
        if req.req_state in (RequestState.PREFILLING, RequestState.DECODING):
            if finished == "stop":
                self._finish_slot(slot, req, "stop")
            elif req.past_deadline():
                self._finish_slot(slot, req, "expired")

    # --------------------------------------------------------------- decode
    def _sweep_dead(self, live: List[Tuple[int, Request]]) -> None:
        """Drop cancellations and already-missed deadlines before paying
        for a step."""
        now = time.monotonic()
        for i, r in list(live):
            if r.req_state is RequestState.CANCELLED:
                self._evict_slot(i, r)
                self.stats["cancelled"] += 1
                live.remove((i, r))
            elif r.past_deadline(now):
                self._evict_slot(i, r)
                self._expire(r)
                live.remove((i, r))

    def _dispatch_step(self) -> bool:
        t_host = time.monotonic()
        if self.speculate:
            dispatched = self._dispatch_verify()
        else:
            dispatched = self._dispatch_decode()
        if dispatched:
            t_end = time.monotonic()
            self.stats["dispatch_s"] += t_end - t_host
            tr = _obs.TRACE
            if tr is not None:
                tr.evt(_obs_events.ENGINE_DISPATCH, -1, "engine", ts=t_host,
                       dur=t_end - t_host)
        return dispatched

    def _dispatch_decode(self) -> bool:
        live = [(i, r) for i, r in enumerate(self._slots)
                if r is not None and i not in self._draining]
        self._sweep_dead(live)
        if not live:
            return False
        S = self.max_batch
        if self.paged:
            # n_valid: 1 = write this slot's token, 0 = idle/draining slot
            # (the kernel writes nothing for it and outputs zeros); one
            # upload into the static buffer
            meta = np.zeros(2 * S, np.int32)
            meta[:S] = self._pos
            meta[[S + i for i, _ in live]] = 1
            self._upload(meta, out=self._meta[:2 * S])
            self._refresh_tables()
        elif self._dense_kv:
            self._upload(self._pos, out=self._meta[:S])
        # dense mode: every slot steps, as under the reference's vmap; an
        # idle slot's rows are garbage until a prefill overwrites them
        tr = _obs.TRACE
        dev = self._timing_events(tr.now(), len(live)) \
            if tr is not None else None
        nxt = self._decode_graph()
        if dev is not None:
            dev.end.record()
        host = self._download(nxt)
        stepped: List[Tuple[int, Request, bool]] = []
        prio = 0
        for i, r in live:
            r.push_device_token(host[i, 0])
            self._pos[i] += 1
            done = r.remaining == 0
            if done:
                self._draining.add(i)
            stepped.append((i, r, done))
            prio = max(prio, r.priority)
        self._inflight += 1
        self.stats["steps"] += 1
        self.stats["slot_steps"] += len(live)
        self.stats["padded_steps"] += S - len(live)
        self.stats["max_active"] = max(self.stats["max_active"], len(live))
        t0 = tr.now() if tr is not None else None
        self.engine.continue_when(TensorOp(nxt, payload=host),
                                  self._on_step_done, (stepped, host, t0, dev),
                                  cr=self.cr_steps, flags=_step_flags(prio))
        return True

    def _on_step_done(self, statuses, meta) -> None:
        """Per-token bookkeeping once the step (and its token copy) has
        finished on the device: deliver each slot's token, then retire
        slots that finished — by budget, stop sequence or deadline —
        releasing their pages in this same continuation."""
        stepped, host, t0, dev = meta
        self._inflight -= 1
        if dev is not None:
            self._device_span(_obs_events.DEV_STEP, -1, dev)
        arr = host.numpy()
        now = time.monotonic()
        tr = _obs.TRACE
        if tr is not None and t0 is not None:
            for slot, req, _ in stepped:
                if tr.want(req.req_id):
                    tr.evt(_obs_events.REQ_STEP, req.req_id, "engine",
                           ts=t0, dur=now - t0, meta=slot)
        for slot, req, done in stepped:
            if done:
                self._draining.discard(slot)
            finished = req.deliver([int(arr[slot, 0])])
            state = req.req_state
            if state is RequestState.FINISHED or \
                    state is RequestState.EXPIRED:
                continue
            if state is RequestState.CANCELLED:
                # a draining slot sees no further dispatch: free it here
                if done and self._slots[slot] is req:
                    self._evict_slot(slot, req)
                    self.stats["cancelled"] += 1
                continue
            if finished == "stop":
                self._finish_slot(slot, req, "stop")
            elif done:
                self._finish_slot(slot, req, "retire")
            elif req.past_deadline(now):
                self._finish_slot(slot, req, "expired")

    # ---------------------------------------------------------- speculative
    def _slot_drafts(self, slot: int, req: Request) -> List[int]:
        """Draft tokens for one slot: the request's own K caps the
        engine's, the token budget caps the window (never past
        ``remaining - 1``: the verify step always emits one real token),
        and the drafter may return fewer still."""
        k = self.speculate if req.speculate is None \
            else min(req.speculate, self.speculate)
        k = min(k, req.remaining - 1)
        if k <= 0 or self._ctx[slot] is None:
            return []
        return list(self.drafter.draft(self._ctx[slot], k))[:k]

    def _dispatch_verify(self) -> bool:
        """One speculative verify step for every steppable slot.

        Slots whose previous verify has not completed are left out (their
        position and next token are known only then); slots with no
        usable draft run with k=0, a plain greedy step for them."""
        live = [(i, r) for i, r in enumerate(self._slots)
                if r is not None and i not in self._verifying]
        self._sweep_dead(live)
        if not live:
            return False
        S, K, W = self.max_batch, self.speculate, self._verify_pages
        # positions | n_valid (1 + live drafts, 0 idle) | drafts (S, K),
        # unfused also | write tables (S, W), null for slots not verified:
        # one upload into the static buffer
        meta = np.zeros(2 * S + S * K + S * W, np.int32)
        meta[:S] = self._pos
        n_drafts = np.zeros(S, np.int32)
        if W:
            wtables = meta[2 * S + S * K:].reshape(S, W)
            wtables[:] = self.pool.null_page
        for i, r in live:
            d = self._slot_drafts(i, r)
            n_drafts[i] = len(d)
            meta[S + i] = 1 + len(d)
            meta[2 * S + i * K:2 * S + i * K + len(d)] = d
            if W:
                wtables[i] = self.pool.write_table(r.page_ids,
                                                   int(self._pos[i]), W)
        self._upload(meta, out=self._meta)
        self._refresh_tables()
        tr = _obs.TRACE
        dev = self._timing_events(tr.now(), len(live)) \
            if tr is not None else None
        emitted, accepts = self._verify_graph()
        if dev is not None:
            dev.end.record()
        emitted_host = self._download(emitted)
        accepts_host = self._download(accepts)
        self._verifying.update(i for i, _ in live)
        self._inflight += 1
        self.stats["steps"] += 1
        self.stats["verify_steps"] += 1
        self.stats["slot_steps"] += len(live)
        self.stats["padded_steps"] += S - len(live)
        self.stats["draft_proposed"] += int(n_drafts.sum())
        self.stats["max_active"] = max(self.stats["max_active"], len(live))
        t0 = tr.now() if tr is not None else None
        self.engine.continue_when(
            TensorOp(emitted, payload=emitted_host), self._on_verify_done,
            (live, emitted_host, accepts_host, n_drafts, t0, dev),
            cr=self.cr_steps,
            flags=_step_flags(max(r.priority for _, r in live)))
        return True

    def _on_verify_done(self, statuses, meta) -> None:
        """Accept bookkeeping once the verify step and its host copies are
        complete: each slot advances by its accepted run plus one token; a
        slot whose run meets its budget retires here, mid-verify."""
        live, emitted_host, accepts_host, n_drafts, t0, dev = meta
        self._inflight -= 1
        if dev is not None:
            self._device_span(_obs_events.DEV_STEP, -1, dev)
        emitted = emitted_host.numpy()
        accepts = accepts_host.numpy()
        now = time.monotonic()
        tr = _obs.TRACE
        if tr is not None and t0 is not None:
            for i, req in live:
                if tr.want(req.req_id):
                    tr.evt(_obs_events.REQ_STEP, req.req_id, "engine",
                           ts=t0, dur=now - t0, meta=i)
        upd_slots: List[int] = []
        upd_tokens: List[int] = []
        for i, req in live:
            state = req.req_state
            # stale: an earlier continuation finished this request and
            # freed the slot, which may have been reseated since; touch
            # nothing keyed by the slot index then
            stale = self._slots[i] is not req
            if not stale:
                self._verifying.discard(i)
            if state is RequestState.FINISHED or \
                    state is RequestState.EXPIRED:
                continue
            if state is RequestState.CANCELLED:
                # cancel mid-verify: the accepted run is dropped
                if not stale:
                    self._evict_slot(i, req)
                    self.stats["cancelled"] += 1
                continue
            a = int(accepts[i])
            n_emit = min(a + 1, req.remaining)
            toks = [int(t) for t in emitted[i, :n_emit]]
            for t in toks:
                req.push_device_token(t)
            req.draft_tokens_proposed += int(n_drafts[i])
            req.draft_tokens_accepted += a
            self.stats["draft_accepted"] += a
            self.stats["spec_tokens"] += n_emit
            finished = req.deliver(toks)
            if self._ctx[i] is not None:
                self._ctx[i].extend(toks)
            self._pos[i] += n_emit
            if finished == "stop":
                self._finish_slot(i, req, "stop")
            elif req.remaining == 0:
                self._finish_slot(i, req, "retire")
            elif req.past_deadline(now):
                self._finish_slot(i, req, "expired")
            else:
                upd_slots.append(i)
                upd_tokens.append(toks[-1])
        if upd_slots:
            # each advancing slot's last token becomes its next input: one
            # upload of mask | values, then a masked update in place of
            # the static token buffer, queued behind any step in flight
            S = self.max_batch
            mv = np.zeros(2 * S, np.int32)
            mv[upd_slots] = 1
            mv[[S + i for i in upd_slots]] = upd_tokens
            dev = self._upload(mv).view(2, S, 1, 1)
            self._tokens.copy_(torch.where(dev[0] != 0, dev[1],
                                           self._tokens))

    def _finish_slot(self, slot: Optional[int], req: Request,
                     kind: str) -> None:
        """Terminal transition from a step-completion continuation: free
        the slot, releasing the request's pages, and finish the request.
        A step already queued for this slot may still write the released
        pages; the stream runs it before any later prefill into them."""
        if slot is not None and self._slots[slot] is req:
            self._draining.discard(slot)
            self._verifying.discard(slot)
            self._evict_slot(slot, req)
        else:
            self._release_pages(req)
        if kind == "expired":
            self._expire(req)
        else:
            self._retire(req, stopped=kind == "stop")

    def _evict_slot(self, slot: int, req: Request) -> None:
        """Free a slot and return the request's pages to the pool (every
        exit path funnels through here, so pages can never leak)."""
        self._slots[slot] = None
        self._pos[slot] = 0
        self._ctx[slot] = None
        if self.paged:
            self._tables[slot, :] = self.pool.null_page
            self._tables_dirty = True
        self._release_pages(req)

    def _release_pages(self, req: Request) -> None:
        if self.paged and req.page_ids:
            tr = _obs.TRACE
            if tr is not None and tr.want(req.req_id):
                tr.evt(_obs_events.REQ_PAGES_RELEASE, req.req_id, "engine",
                       meta=len(req.page_ids))
            self.pool.release(req.page_ids)
            req.page_ids = []

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

    def _expire(self, req: Request) -> None:
        """Deadline-expired: fail the request (partial tokens kept)."""
        if req.expire():
            self.stats["expired"] += 1
        elif req.req_state is RequestState.CANCELLED:
            self.stats["cancelled"] += 1

    # ----------------------------------------------------------------- loop
    def step(self) -> bool:
        """One loop iteration: admit, dispatch (windowed), progress.
        Returns True if any work was started or completed."""
        admitted = self._admit()
        dispatched = False
        if self._inflight < self.max_inflight:
            dispatched = self._dispatch_step()
        before = self.stats["retired"]
        self.engine.tick()   # discover step completions, run continuations
        return bool(admitted) or dispatched or \
            self.stats["retired"] != before

    @property
    def idle(self) -> bool:
        """Nothing queued, occupied, or in flight — including prefill/step
        continuations still registered on the step CR."""
        return (not self._pending_intake() and self.active == 0
                and self._inflight == 0
                and self.cr_steps.active_count == 0)

    def _pending_intake(self) -> bool:
        return bool(self.batcher.queued or self.batcher.cr.active_count)

    def run(self, timeout: Optional[float] = None,
            idle_sleep: float = 5e-5, until=None) -> List[Request]:
        """Drive the loop until intake is closed and everything retired
        (or until ``until()`` is true, when given)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        done = until if until is not None else \
            (lambda: self.batcher.closed and self.idle)
        while not done():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"serve loop timed out: active={self.active} "
                    f"inflight={self._inflight} queued={self.batcher.queued}")
            if not self.step():
                time.sleep(idle_sleep)
        return self.retired

    def _metrics_flat(self) -> dict:
        out = summarize(self.retired)
        out.update(self.stats)
        out["paged"] = self.paged
        out["fused"] = self.fused
        out["speculate"] = self.speculate
        if self.stats["draft_proposed"]:
            # engine-wide accept rate (cancelled requests included;
            # summarize() reports the finished requests' rate)
            out["accept_rate_engine"] = (self.stats["draft_accepted"]
                                         / self.stats["draft_proposed"])
        if self.paged:
            out.update(self.pool.metrics())
        return out

    def metrics(self) -> ServeMetrics:
        return ServeMetrics.from_flat(self._metrics_flat())

    def shutdown(self) -> None:
        self.batcher.close()
        if self._own_engine:
            self.engine.shutdown()


def serve_requests(cfg: ModelConfig, params: Any,
                   requests: Sequence[Request], *,
                   max_batch: int = 4, max_cache_len: int = 256,
                   timeout: float = 300.0, **kwargs: Any) -> List[Request]:
    """Convenience: serve a fixed request list to completion, in order."""
    eng = ServeEngine(cfg, params, max_batch=max_batch,
                      max_cache_len=max_cache_len, **kwargs)
    try:
        for r in requests:
            eng.submit(r)
        eng.close_intake()
        eng.run(timeout=timeout)
    finally:
        eng.shutdown()
    return list(requests)

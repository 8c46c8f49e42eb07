"""Multi-replica front door: prefix-affinity routing, weighted tenant
fairness, and heartbeat-driven failover — all reactions in continuations.
Counterpart of ``repro/serve/router.py``.

One decode loop is not a fleet. The ``Router`` fronts N serving replicas
— each a full ``EngineLike`` tier (``ServeEngine`` or ``DisaggServer``)
— and speaks to them ONLY through the typed ``core.transport`` control
plane plus the continuation machinery, the same discipline
``serve.disagg`` established for the prefill/decode boundary: the
``Request`` object is shared in-process for token delivery, but
everything the router *decides* on (routing, liveness, residency) rides
transport messages, so a multi-host backend can replace the in-process
transport without touching the policy.

Three policies, one loop:

* **Prefix-affinity routing** — prompts are content-hashed with the very
  chained page digests ``PagePool`` indexes resident pages under
  (``kv_cache.prefix_keys``), and each replica *gossips* its resident
  digest set on a control tag whenever it changes. A request routes to
  the replica holding the longest leading run of its prompt's page keys
  — where its KV pages already live, so the replica's prefix cache turns
  the prompt into a suffix-prefill — falling back to the least-loaded
  replica when there is no hit or the affine replica is saturated.
  Dispatches insert the routed prompt's digests optimistically, so a
  burst of same-prefix traffic lands together without waiting a gossip
  round-trip.
* **Weighted per-tenant fairness** — intake is a ``FairBatcher``: strict
  ``priority`` classes, weighted deficit round robin across
  ``config.tenant`` lanes within each class. On top sits per-tenant
  admission control: more than ``quota`` outstanding requests refuses
  the submit with ``QuotaExceeded`` carrying a retry-after hint (the
  router's EWMA of request latency).
* **Failure-driven requeue** — every replica ``beat()``s a
  ``HeartbeatSender`` from its step loop; the router runs the
  ``HeartbeatMonitor`` whose missed-deadline sweep (a continuation
  chained on a ``TimerOp`` promise — no poller thread) declares a silent
  replica dead *inside the sweep continuation*: its pending transport
  receives are cancelled (``Transport.cancel_posted`` — cancelled
  statuses flow to their continuations, paper Listing 4), its in-flight
  requests requeue at the **head** of their priority class, and the
  affinity map shrinks ``runtime.elastic``-style to the surviving
  replicas.

**Failover replay.** The router never hands a client's ``Request`` to a
replica. Each dispatch creates a *shadow* request (same prompt, same
config, same arrival time) whose attached stream is a ``_ReplayAdapter``
forwarding committed tokens into the original ``Request.deliver``. On
replica death the shadow is simply cancelled (the original unaffected)
and a fresh shadow restarts from the prompt on a surviving replica,
skipping the first ``original.delivered`` regenerated tokens — greedy
decode is deterministic, so the replayed stream is token-identical to an
uninterrupted run, and the client's stream observes at most a latency
blip. Zero requests are lost.

On the card (the port): replicas are ``ServeEngine``s (or any
``EngineLike`` tier, ``DisaggServer`` included) sharing one device, each
with its own pool and captured step graphs, all driven by the router's
one loop thread. A killed replica may still have step graphs queued on
the card: its pages return to its pool only through its own step
continuations, as in the reference, so the router keeps stepping a dead
tier (``ReplicaWorker.quiesce``) until its pool drains. Nothing
synchronizes the card.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, List, Optional, Set, Union

import numpy as np

from repro_torch.core import (ContinueFlags, Engine, OpState, Scheduler,
                              Transport)
from repro_torch.runtime.heartbeat import HeartbeatMonitor, HeartbeatSender
from repro_torch.serve.batcher import FairBatcher
from repro_torch.serve.config import QuotaExceeded
from repro_torch.serve.disagg import DisaggServer
from repro_torch.serve.engine import ServeEngine
from repro_torch.obs import events as _obs_events
from repro_torch.obs import tracer as _obs
from repro_torch.serve.kv_cache import pages_for, prefix_keys
from repro_torch.serve.metrics import ServeMetrics, transport_fields
from repro_torch.serve.protocol import EngineLike
from repro_torch.serve.request import Request, RequestState, summarize
from repro_torch.util import resolve_device

ROUTER_RANK = 0

# control-plane channels on the router's transport (replica ranks are
# 1..N; heartbeats ride runtime.heartbeat.HEARTBEAT_TAG)
ROUTE_TAG = 8001
GOSSIP_TAG = 8002

_FLAGS = ContinueFlags(enqueue_complete=True)


# --------------------------------------------------------------- messages
@dataclass(frozen=True)
class RouteMsg:
    """Hand one expected request to a replica (ids only on the wire;
    the ``Request`` object was registered via ``ReplicaWorker.expect``)."""
    req_id: int


@dataclass(frozen=True)
class PrefixDigestMsg:
    """A replica's resident-prefix gossip: the digest set its ``PagePool``
    currently indexes (sent only when it changed)."""
    rank: int
    digests: FrozenSet[bytes]


# ---------------------------------------------------------- failover glue
class _ReplayAdapter:
    """The shadow request's stream: forwards committed tokens into the
    original, skipping the first ``skip`` regenerated ones (already
    delivered before the previous replica died). Greedy determinism
    makes the skipped prefix byte-identical, so the original's stream
    sees each token exactly once."""

    __slots__ = ("original", "_skip")

    def __init__(self, original: Request, skip: int) -> None:
        self.original = original
        self._skip = skip

    def _publish(self, toks: List[int]) -> None:
        if self._skip:
            n = min(self._skip, len(toks))
            self._skip -= n
            toks = toks[n:]
        if toks:
            self.original.on_first_token()
            self.original.deliver(toks)

    def _close(self, reason: str,
               error: Optional[BaseException] = None) -> None:
        if reason == "finished":
            self.original.retire()
        elif reason == "expired":
            self.original.expire()
        # "cancelled" is router-initiated (failover re-shadow, or the
        # original was cancelled first): never propagated to the original

    # stream-protocol stubs (Request.attach_stream only uses the above)
    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"_ReplayAdapter(req={self.original.req_id}, " \
               f"skip={self._skip})"


class _Tracked:
    """Router-side bookkeeping for one client request."""

    __slots__ = ("original", "shadow", "rank", "replays", "seq")

    def __init__(self, original: Request, seq: int) -> None:
        self.original = original
        self.shadow: Optional[Request] = None
        self.rank: Optional[int] = None
        self.replays = 0
        self.seq = seq


# ------------------------------------------------------------ the replica
def _tier_core(tier: EngineLike) -> Any:
    """The object holding paged-serving limits/pool for a tier."""
    return tier.decode if isinstance(tier, DisaggServer) else tier


class ReplicaWorker:
    """One replica behind the router: an ``EngineLike`` tier plus the
    replica half of the control plane — a standing routed-work receive
    (re-armed by its own continuation), heartbeat beats from the step
    loop, and resident-prefix gossip whenever the digest set changes.

    Driven by the router's single driver thread. ``kill()`` simulates
    replica death: the worker stops stepping and beating; the monitor's
    sweep notices the silence.
    """

    def __init__(self, tier: EngineLike, *, engine: Engine,
                 transport: Transport, rank: int,
                 heartbeat_interval_s: float = 0.005) -> None:
        self.tier = tier
        self.engine = engine
        self.transport = transport
        self.rank = rank
        self.alive = True
        self.sender = HeartbeatSender(transport, rank, ROUTER_RANK,
                                      interval_s=heartbeat_interval_s)
        self.cr = engine.continue_init()
        self._expected: Dict[int, Request] = {}
        self._last_digests: Optional[FrozenSet[bytes]] = None
        self._route_op: Optional[Any] = None
        self._post_route_recv()

    # ---------------------------------------------------------- limits
    @property
    def core(self) -> Any:
        return _tier_core(self.tier)

    @property
    def pool(self):
        return getattr(self.core, "pool", None)

    # ----------------------------------------------------- control plane
    def expect(self, req: Request) -> None:
        """Register the Request a forthcoming ``RouteMsg`` names (the
        wire carries ids only — same registry idiom as ``disagg``)."""
        self._expected[req.req_id] = req

    def _post_route_recv(self) -> None:
        op = self.transport.irecv(self.rank, source=ROUTER_RANK,
                                  tag=ROUTE_TAG)
        self._route_op = op
        self.engine.continue_when(op, self._on_route, op, cr=self.cr,
                                  flags=_FLAGS)

    def _on_route(self, statuses, op) -> None:
        if op.state is OpState.CANCELLED:
            return                       # death/shutdown: don't re-arm
        msg: RouteMsg = op.status.payload
        self._post_route_recv()          # re-arm before processing
        req = self._expected.pop(msg.req_id, None)
        if req is None:
            raise RuntimeError(f"routed unknown request {msg.req_id}")
        if req.req_state is RequestState.CANCELLED:
            return                       # died between dispatch and here
        self.tier.submit(req)

    def _gossip(self) -> None:
        pool = self.pool
        if pool is None:
            return
        digests = pool.prefix_digests()
        if digests != self._last_digests:
            self._last_digests = digests
            self.transport.isend(self.rank, ROUTER_RANK, GOSSIP_TAG,
                                 PrefixDigestMsg(self.rank, digests))

    # --------------------------------------------------------------- loop
    def step(self) -> bool:
        if not self.alive:
            return False
        self.sender.beat()
        progressed = self.tier.step()
        self._gossip()
        return progressed

    def kill(self) -> None:
        """Simulate replica death: stop stepping and beating (the
        monitor's sweep will flag the silence)."""
        self.alive = False

    def quiesce(self, max_steps: int = 500) -> bool:
        """Reclaim a dead replica's lease: with every in-flight shadow
        already cancelled by the router, drive the tier's own sweep
        machinery until its pages drain — the in-process analogue of the
        elastic controller tearing down a failed rank's resources.
        Returns True once drained. On the card the tier's last steps may
        still be queued there, and its pages return only in their
        continuations: the router calls this again from its loop until it
        returns True, and never waits on the card."""
        pool = self.pool
        for _ in range(max_steps):
            if (pool is None or pool.pages_in_use == 0) and self.tier.idle:
                return True
            self.tier.step()
        return False

    def shutdown(self) -> None:
        if self._route_op is not None and \
                self._route_op.state is OpState.PENDING:
            self._route_op.cancel()
        self.tier.shutdown()


# -------------------------------------------------------------- the router
class Router:
    """The multi-replica front door (see module docstring).

    Satisfies ``serve.protocol.EngineLike``: ``ServeClient`` binds to a
    ``Router`` exactly as it binds to a single engine. Single-consumer
    like every tier: one thread drives ``step()``/``run()``; any thread
    may ``submit()``.

    Construction: either pass ``replicas=[tier, ...]`` (pre-built
    ``EngineLike`` tiers sharing ``engine=``), or ``(cfg, params)`` with
    ``n_replicas`` and engine kwargs to build homogeneous ``ServeEngine``
    replicas. Policy knobs:

    * ``weights`` / ``quantum`` — tenant fairness (``FairBatcher``).
    * ``quota`` — max outstanding requests per tenant (int for all, or
      ``{tenant: n}``; ``None`` = unlimited). Refusal raises
      ``QuotaExceeded`` with ``retry_after_s`` from the latency EWMA.
    * ``saturation`` — per-replica in-flight cap before affinity falls
      back to least-loaded (default ``2 * max_batch``).
    * ``heartbeat_timeout_s`` / ``sweep_interval_s`` — failure detector.

    Built replicas take ``device`` (default ``"cuda"``; ``"cpu"`` runs the
    kernels' plain versions) among the engine kwargs. Construct the
    router on the thread that owns the card: each replica captures its
    step graph then.
    """

    def __init__(self, cfg: Any = None, params: Any = None, *,
                 replicas: Optional[List[EngineLike]] = None,
                 n_replicas: int = 2,
                 engine: Optional[Engine] = None,
                 scheduler: Union[str, Scheduler] = "fifo",
                 weights: Optional[Dict[str, float]] = None,
                 quantum: float = 32.0,
                 quota: Union[None, int, Dict[str, int]] = None,
                 saturation: Optional[int] = None,
                 heartbeat_interval_s: float = 0.005,
                 heartbeat_timeout_s: float = 0.25,
                 sweep_interval_s: float = 0.02,
                 **engine_kwargs: Any) -> None:
        if replicas is None:
            # the replicas' device (default the card) before anything else
            resolve_device(engine_kwargs.get("device", "cuda"))
        self._own_engine = engine is None
        self.engine = engine if engine is not None else \
            Engine(scheduler=scheduler)
        if replicas is None:
            if cfg is None or params is None:
                raise ValueError("Router needs (cfg, params) or replicas=")
            replicas = [ServeEngine(cfg, params, engine=self.engine,
                                    **engine_kwargs)
                        for _ in range(int(n_replicas))]
        elif engine_kwargs:
            raise ValueError("replicas= and engine kwargs are exclusive")
        if not replicas:
            raise ValueError("Router needs at least one replica")
        for i, tier in enumerate(replicas):
            if not isinstance(tier, EngineLike):
                raise TypeError(f"replica {i} does not satisfy EngineLike: "
                                f"{type(tier).__name__}")
        self.transport = Transport(len(replicas) + 1, engine=self.engine)
        self.workers = [
            ReplicaWorker(tier, engine=self.engine, transport=self.transport,
                          rank=i + 1,
                          heartbeat_interval_s=heartbeat_interval_s)
            for i, tier in enumerate(replicas)]
        self.batcher = FairBatcher(self.engine, weights=weights,
                                   quantum=quantum,
                                   on_drop=self._on_intake_drop)
        # per-request lifecycle continuations: poll_only routes them to
        # step()'s cr.test() (driver thread), enqueue_complete lets a
        # request that raced to terminal still flow through them
        self.cr_track = self.engine.continue_init(poll_only=True,
                                                  enqueue_complete=True)
        if saturation is None:
            saturation = 2 * max(int(getattr(w.core, "max_batch", 1))
                                 for w in self.workers)
        self.saturation = max(1, int(saturation))
        self._quota = quota
        # tenant outstanding counts are read on submit() (client threads)
        # and written by tracking continuations (driver thread)
        self._quota_lock = threading.Lock()
        self._outstanding: Dict[str, int] = {}
        self._ewma_latency: Optional[float] = None
        self._tracked: Dict[int, _Tracked] = {}       # original.req_id ->
        self._track_seq = 0
        self._rank_inflight: Dict[int, int] = {w.rank: 0
                                               for w in self.workers}
        self._digests: Dict[int, Set[bytes]] = {w.rank: set()
                                                for w in self.workers}
        self._retired: List[Request] = []
        self._retired_lock = threading.Lock()
        self.stats = {"routed": 0, "affinity_hits": 0, "affinity_misses": 0,
                      "quota_refused": 0, "failovers": 0, "requeued": 0,
                      "retired": 0, "cancelled": 0, "expired": 0}
        # failure detector: replicas beat on the router transport; the
        # sweep is a TimerOp promise chain driven by progress() — every
        # failure reaction below runs inside that sweep continuation
        self.monitor = HeartbeatMonitor(
            self.transport, self.engine, ROUTER_RANK,
            watched=[w.rank for w in self.workers],
            timeout_s=heartbeat_timeout_s,
            sweep_interval_s=sweep_interval_s,
            on_failure=self._on_replica_dead,
            # the router's loop runs replica prefills inline, eagerly: a
            # first launch of a new shape (lazy module loading, a
            # cudaMalloc) stalls the sweep, and must not read as silence
            stall_guard_s=heartbeat_timeout_s)
        # kill_replica instants, and the seconds from each to the requeue
        # of that replica's work in the sweep continuation
        self._killed_at: Dict[int, float] = {}
        self.failover_s: List[float] = []
        self._reclaiming: Set[int] = set()    # dead, pool not drained yet
        self._gossip_ops: Dict[int, Any] = {}
        for w in self.workers:
            self._post_gossip_recv(w.rank)

    # ------------------------------------------------------------- helpers
    @property
    def live_workers(self) -> List[ReplicaWorker]:
        return [w for w in self.workers if w.alive]

    def _worker(self, rank: int) -> ReplicaWorker:
        return self.workers[rank - 1]

    # ------------------------------------------------------------- clients
    def submit(self, request: Request) -> Request:
        """Thread-safe intake: validate against replica limits, enforce
        the tenant quota, then queue on the fairness scheduler."""
        self._validate(request)
        tenant = request.tenant
        limit = self._tenant_quota(tenant)
        with self._quota_lock:
            held = self._outstanding.get(tenant, 0)
            if limit is not None and held >= limit:
                self.stats["quota_refused"] += 1
                retry = self._ewma_latency if self._ewma_latency else 0.05
                raise QuotaExceeded(
                    f"tenant {tenant!r} has {held} outstanding requests "
                    f"(quota {limit}); retry in ~{retry:.3f}s",
                    tenant=tenant, retry_after_s=retry)
            self._outstanding[tenant] = held + 1
        tr = _obs.TRACE
        if tr is not None and tr.want(request.req_id):
            tr.evt(_obs_events.REQ_SUBMIT, request.req_id, "router")
        tracked = _Tracked(request, self._track_seq)
        self._track_seq += 1
        self._tracked[request.req_id] = tracked
        # the original's terminal transition — retire via replay, user
        # cancel, expiry — funnels through ONE tracking continuation
        self.engine.continue_when(request, self._on_original_done, tracked,
                                  cr=self.cr_track)
        self.batcher.submit(request)
        return request

    def _tenant_quota(self, tenant: str) -> Optional[int]:
        if self._quota is None:
            return None
        if isinstance(self._quota, dict):
            return self._quota.get(tenant)
        return int(self._quota)

    def _validate(self, request: Request) -> None:
        core = self.workers[0].core
        if getattr(core, "paged", False):
            plen = int(np.asarray(request.prompt).reshape(-1).shape[0])
            total = plen + request.max_new_tokens
            if total > core.max_seq_len:
                raise ValueError(f"request needs {total} tokens > "
                                 f"max_seq_len={core.max_seq_len}")
            if pages_for(total, core.page_size) > core.pool.total_pages:
                raise ValueError(
                    "request needs more pages than a replica pool holds "
                    f"({core.pool.total_pages})")

    def close_intake(self) -> None:
        self.batcher.close()

    @property
    def retired(self) -> List[Request]:
        with self._retired_lock:
            return list(self._retired)

    # --------------------------------------------------- lifecycle tracking
    def _on_intake_drop(self, req: Request) -> None:
        """FairBatcher refused a queued request (cancelled while queued,
        or past-deadline). The tracking continuation on the request does
        the accounting; nothing to release here (no pages at intake)."""

    def _on_original_done(self, statuses, tracked: _Tracked) -> None:
        req = tracked.original
        self._tracked.pop(req.req_id, None)
        with self._quota_lock:
            held = self._outstanding.get(req.tenant, 0)
            if held:
                self._outstanding[req.tenant] = held - 1
        state = req.req_state
        if state is RequestState.FINISHED:
            lat = (req.finish_time or time.monotonic()) - req.arrival_time
            self._ewma_latency = lat if self._ewma_latency is None else \
                0.8 * self._ewma_latency + 0.2 * lat
            with self._retired_lock:
                self._retired.append(req)
            self.stats["retired"] += 1
        elif state is RequestState.CANCELLED:
            self.stats["cancelled"] += 1
        else:
            self.stats["expired"] += 1
        # a client cancel/expiry while a shadow is still decoding: reap it
        shadow = tracked.shadow
        if shadow is not None and not shadow.is_terminal \
                and state is not RequestState.FINISHED:
            shadow.cancel()

    def _on_shadow_done(self, statuses, meta) -> None:
        rank, shadow = meta
        self._rank_inflight[rank] -= 1

    # ------------------------------------------------------------- routing
    def _prompt_keys(self, prompt: Any) -> List[bytes]:
        core = self.workers[0].core
        if not getattr(core, "paged", False):
            return []
        ps = core.page_size
        toks = np.asarray(prompt, np.int32).reshape(-1)
        # cap one token short of the prompt, mirroring match_prefix: a
        # "hit" here must mean actual page reuse at the replica
        return prefix_keys(toks, ps, (len(toks) - 1) // ps)

    def _choose_replica(self, req: Request) -> Optional[ReplicaWorker]:
        """Affinity first (longest leading digest run, not saturated),
        else least-loaded live replica with headroom."""
        live = [w for w in self.live_workers
                if self._rank_inflight[w.rank] < self.saturation]
        if not live:
            return None
        keys = self._prompt_keys(req.prompt)
        best, best_score = None, 0
        for w in live:
            digests = self._digests[w.rank]
            score = 0
            for k in keys:
                if k not in digests:
                    break
                score += 1
            if score > best_score or (
                    best is not None and score == best_score and score > 0
                    and self._rank_inflight[w.rank]
                    < self._rank_inflight[best.rank]):
                best, best_score = w, score
        if best is not None:
            self.stats["affinity_hits"] += 1
            return best
        self.stats["affinity_misses"] += 1
        return min(live, key=lambda w: (self._rank_inflight[w.rank], w.rank))

    def _dispatch(self) -> int:
        capacity = sum(max(0, self.saturation - self._rank_inflight[w.rank])
                       for w in self.live_workers)
        if capacity == 0:
            return 0
        routed = 0
        for req in self.batcher.admit(capacity):
            tracked = self._tracked.get(req.req_id)
            if tracked is None:
                # submitted around the router (protocol allows it): track
                # now so failover still covers it — quota was never held
                tracked = _Tracked(req, self._track_seq)
                self._track_seq += 1
                self._tracked[req.req_id] = tracked
                self.engine.continue_when(req, self._on_original_done,
                                          tracked, cr=self.cr_track)
            worker = self._choose_replica(req)
            if worker is None:
                self.batcher.requeue(req)
                break
            self._send_to(worker, tracked)
            routed += 1
        return routed

    def _send_to(self, worker: ReplicaWorker, tracked: _Tracked) -> None:
        """Create the engine-side shadow and hand it to ``worker`` over
        the route channel; the original never leaves the router."""
        orig = tracked.original
        skip = orig.rewind_holdback()
        shadow = Request(orig.prompt, orig.config,
                         arrival_time=orig.arrival_time)
        shadow.attach_stream(_ReplayAdapter(orig, skip))
        tr = _obs.TRACE
        if tr is not None and tr.want(shadow.req_id):
            # the link event lets the exporter collapse the shadow's
            # whole replica-side timeline onto the original's track
            # (transitively, across repeated failover re-shadows)
            tr.evt(_obs_events.REQ_LINK, shadow.req_id, "router",
                   meta=orig.req_id)
        tracked.shadow = shadow
        tracked.rank = worker.rank
        self._rank_inflight[worker.rank] += 1
        self.engine.continue_when(shadow, self._on_shadow_done,
                                  (worker.rank, shadow), cr=self.cr_track)
        worker.expect(shadow)
        self.transport.isend(ROUTER_RANK, worker.rank, ROUTE_TAG,
                             RouteMsg(shadow.req_id))
        # optimistic digest insert: same-prefix traffic right behind this
        # request routes to the same replica without a gossip round-trip
        self._digests[worker.rank].update(self._prompt_keys(orig.prompt))
        self.stats["routed"] += 1

    # -------------------------------------------------------------- gossip
    def _post_gossip_recv(self, rank: int) -> None:
        op = self.transport.irecv(ROUTER_RANK, source=rank, tag=GOSSIP_TAG)
        self._gossip_ops[rank] = op
        self.engine.continue_when(op, self._on_gossip, (rank, op),
                                  cr=self._worker(rank).cr, flags=_FLAGS)

    def _on_gossip(self, statuses, meta) -> None:
        rank, op = meta
        if op.state is OpState.CANCELLED:
            return                       # replica dead: don't re-arm
        msg: PrefixDigestMsg = op.status.payload
        self._post_gossip_recv(rank)
        if self._rank_inflight[rank] == 0:
            # authoritative replace (picks up evictions) only when no
            # optimistic in-flight entries could be clobbered
            self._digests[rank] = set(msg.digests)
        else:
            self._digests[rank].update(msg.digests)

    # ------------------------------------------------------------ failover
    def _on_replica_dead(self, rank: int) -> None:
        """Runs inside the monitor's sweep continuation. Tear the dead
        replica out of the fleet and requeue its in-flight work."""
        worker = self._worker(rank)
        worker.kill()                    # idempotent when already killed
        self.monitor.unwatch(rank)
        self.stats["failovers"] += 1
        # cancel the control plane: the replica's pending receives (the
        # standing route recv) and the router's receives from it (gossip).
        # Their continuations observe CANCELLED and do not re-arm.
        self.transport.cancel_posted(rank)
        self.transport.cancel_posted(ROUTER_RANK, source=rank,
                                     tag=GOSSIP_TAG)
        self._digests[rank].clear()      # elastic shrink of the affinity map
        # requeue this replica's in-flight requests at the head of their
        # priority class. Reverse tracked order: _push_head prepends, so
        # iterating newest-first restores oldest-first at the head.
        stranded = sorted((t for t in self._tracked.values()
                           if t.rank == rank),
                          key=lambda t: t.seq, reverse=True)
        tr = _obs.TRACE
        for t in stranded:
            shadow, t.shadow, t.rank = t.shadow, None, None
            t.replays += 1
            if shadow is not None and not shadow.is_terminal:
                shadow.cancel()          # adapter ignores router cancels
            if not t.original.is_terminal:
                if tr is not None and tr.want(t.original.req_id):
                    tr.evt(_obs_events.REQ_REPLAY, t.original.req_id,
                           "router", meta=rank)
                self.batcher.requeue(t.original)
                self.stats["requeued"] += 1
        killed = self._killed_at.pop(rank, None)
        if killed is not None:
            self.failover_s.append(time.monotonic() - killed)
        # reclaim the dead tier's resources (pages of cancelled shadows);
        # what is still queued on the card drains from step()
        if not worker.quiesce():
            self._reclaiming.add(rank)

    def kill_replica(self, rank: int) -> None:
        """Test/chaos hook: silence a replica NOW (stops its stepping and
        beats); detection and failover still flow through the heartbeat
        sweep, exactly as a real silent death would."""
        self._killed_at.setdefault(rank, time.monotonic())
        self._worker(rank).kill()

    # ----------------------------------------------------------------- loop
    def step(self) -> bool:
        routed = self._dispatch()
        progressed = bool(routed)
        for w in self.workers:
            progressed = w.step() or progressed
        for rank in list(self._reclaiming):
            if self._worker(rank).quiesce(max_steps=1):
                self._reclaiming.discard(rank)
        self.cr_track.test()             # lifecycle continuations
        self.engine.tick()
        self.monitor.progress()          # drives the sweep promise chain
        return progressed

    @property
    def idle(self) -> bool:
        return (not self._pending_intake() and not self._tracked
                and not self._reclaiming
                and self.cr_track.active_count == 0
                and all(w.tier.idle for w in self.live_workers))

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
                    f"router loop timed out: queued={self.batcher.queued} "
                    f"tracked={len(self._tracked)} "
                    f"live={[w.rank for w in self.live_workers]}")
            if not self.step():
                time.sleep(idle_sleep)
        return self.retired

    # -------------------------------------------------------------- metrics
    def metrics(self) -> ServeMetrics:
        out = summarize(self.retired)
        out.update(self.stats)
        routed = self.stats["routed"]
        out["affinity_hit_rate"] = \
            self.stats["affinity_hits"] / routed if routed else 0.0
        out["replicas"] = len(self.workers)
        out["replicas_live"] = len(self.live_workers)
        out["pages_in_use"] = sum(w.pool.pages_in_use
                                  for w in self.workers
                                  if w.pool is not None)
        out["total_pages"] = sum(w.pool.total_pages
                                 for w in self.workers if w.pool is not None)
        out["rank_inflight"] = dict(self._rank_inflight)
        out["per_tenant"] = {t: dict(s) for t, s
                             in self.batcher.tenant_stats.items()}
        out["per_replica"] = {w.rank: w.tier.metrics()
                              for w in self.workers}
        st = self.transport.stats()
        out["transport"] = st
        out.update(transport_fields(st))
        return ServeMetrics.from_flat(out)

    def shutdown(self) -> None:
        self.batcher.close()
        self.monitor.stop()
        self.transport.cancel_posted(ROUTER_RANK)  # heartbeat + gossip recvs
        for w in self.workers:
            w.shutdown()
        self.transport.shutdown()
        if self._own_engine:
            self.engine.shutdown()

"""Admission batching on a ``poll_only + enqueue_complete`` CR.

Clients may submit requests from any thread at any rate. Each submission
is an already-complete push op registered on a CR configured exactly like
the paper's burst-tolerant activation handling (§3.5 info keys, §5.3.1
usage):

* ``enqueue_complete`` — registration never takes the immediate-completion
  fast path, so every submission flows through the continuation machinery
  uniformly (no flag handling on the submit path);
* ``poll_only``        — admission callbacks run *only* inside
  ``cr.test()``, which only the decode loop calls. A burst of submissions
  therefore queues on the CR without ever preempting in-flight decode
  dispatch, and the loop admits on its own step boundaries.

``admit(n)`` is the decode loop's entry point: one ``cr.test()`` drains
the queued admission callbacks (cheap appends), then up to ``n`` requests
are handed out in **QoS order**: strictly by ``config.priority`` (higher
first), arrival order within a priority class. Requests whose
``config.deadline_s`` already passed while queued are *refused* — expired
with ``DeadlineExceeded`` instead of wasting prefill compute — and
capacity-deferred requests requeue at the head of their priority class.

The queue discipline itself is pluggable (``_push``/``_push_head``/
``_pop`` hooks): ``FairBatcher`` keeps the strict priority classes but
runs weighted deficit round robin across tenants *within* each class —
the multi-replica router's admission scheduler.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.core.completable import Completable
from repro_torch.core.engine import Engine
from repro_torch.core.status import Status
from repro_torch.serve.request import Request, RequestState


class _SubmitOp(Completable):
    """Push op representing 'a request arrived'; complete at construction."""

    @property
    def supports_push(self) -> bool:
        return True


class Batcher:
    """Thread-safe request intake feeding a single decode loop.

    ``on_drop``: optional callback invoked (loop thread, from ``admit``)
    for every queued request refused without being handed out — cancelled
    while queued, or expired past its deadline. Role engines that attach
    resources *before* admission (the disaggregated decode role queues
    requests whose KV pages already landed) use it to release them; the
    plain colocated intake queues nothing resource-bearing and leaves it
    unset."""

    def __init__(self, engine: Engine,
                 on_drop: Optional[Callable[[Request], None]] = None) -> None:
        self.engine = engine
        self._on_drop = on_drop
        # CR-level defaults (new-style keys; every admission wants both):
        # individual registrations could override via flags=, but intake
        # is deliberately uniform
        self.cr = engine.continue_init(poll_only=True, enqueue_complete=True)
        # priority heap: (-priority, seq, Request). seq is a monotone
        # arrival counter, so equal-priority requests pop in arrival
        # order; requeued requests get a *decreasing* seq and land at the
        # head of their priority class. Only mutated by admission
        # callbacks / admit / requeue, i.e. on the decode-loop thread.
        self._pending: List[tuple] = []
        self._arrival_seq = itertools.count()
        self._head_seq = itertools.count(-1, -1)
        # one mutex makes the closed-check and the CR registration atomic
        # against close(): without it a submission racing close() could pass
        # the check, then register on the CR of a closed batcher and sit
        # there forever (the loop stops admitting once drained).
        self._intake_lock = threading.Lock()
        self._closed = False
        self.stats = {"submitted": 0, "admitted": 0, "dropped_cancelled": 0,
                      "refused_closed": 0, "submitted_speculative": 0,
                      "expired_queued": 0}

    # ---------------------------------------------------------- client side
    def submit(self, request: Request) -> Request:
        """Enqueue a request (any thread). Returns the request for chaining."""
        with self._intake_lock:
            if self._closed:
                self.stats["refused_closed"] += 1
                raise RuntimeError("batcher intake is closed")
            self.stats["submitted"] += 1
            # per-request speculate=K knob (None rides the engine default,
            # which this intake-side counter cannot see)
            if request.speculate:
                self.stats["submitted_speculative"] += 1
            op = _SubmitOp()
            op._complete(Status(payload=request))
            # poll_only routes the ready continuation to the CR's private
            # queue; nothing executes on this (client) thread, so holding
            # the lock across registration is cheap.
            self.engine.continue_when(op, self._on_submit, request,
                                      cr=self.cr)
        return request

    def close(self) -> None:
        """Stop accepting new submissions (already-queued ones still admit)."""
        with self._intake_lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._intake_lock:
            return self._closed

    # ----------------------------------------------------------- loop side
    # The queue discipline lives behind three overridable hooks (_push /
    # _push_head / _pop) so subclasses can change ORDERING without
    # touching the intake CR, the drop/refusal policy, or the drain
    # contract. The base discipline: strict priority, FIFO within class.
    def _push(self, request: Request) -> None:
        heapq.heappush(self._pending,
                       (-request.priority, next(self._arrival_seq), request))

    def _push_head(self, request: Request) -> None:
        heapq.heappush(self._pending,
                       (-request.priority, next(self._head_seq), request))

    def _pop(self) -> Optional[Request]:
        if not self._pending:
            return None
        return heapq.heappop(self._pending)[2]

    def _queue_len(self) -> int:
        return len(self._pending)

    def _on_submit(self, statuses, request: Request) -> None:
        self._push(request)

    def admit(self, max_n: int) -> List[Request]:
        """Drain queued submissions and hand out up to ``max_n`` requests
        in QoS order, refusing past-deadline work.

        Must be called from the decode loop only (single-tester CR rule).
        """
        self.cr.test()
        now = time.monotonic()
        out: List[Request] = []
        while len(out) < max_n:
            req = self._pop()
            if req is None:
                break
            if req.req_state is RequestState.CANCELLED:
                self.stats["dropped_cancelled"] += 1
                if self._on_drop is not None:
                    self._on_drop(req)
                continue
            if req.past_deadline(now):
                # refuse: the deadline passed while the request queued —
                # expire it here instead of spending prefill on it
                req.expire()
                self.stats["expired_queued"] += 1
                if self._on_drop is not None:
                    self._on_drop(req)
                continue
            req.on_admitted()
            out.append(req)
        self.stats["admitted"] += len(out)
        return out

    def requeue(self, request: Request) -> None:
        """Return an admitted-but-unplaceable request to the head of its
        priority class (loop thread only — the paged engine defers
        admission when the page pool can't cover the request's worst-case
        footprint, and the router re-queues a dead replica's in-flight
        work)."""
        request.on_requeued()
        self._push_head(request)
        self.stats["admitted"] -= 1

    @property
    def queued(self) -> int:
        """Submissions already transferred to the pending queue (does not
        count ones still sitting on the CR until the next admit())."""
        return self._queue_len()

    @property
    def drained(self) -> bool:
        """True when intake is closed and nothing is waiting for admission."""
        return (self.closed and self._queue_len() == 0
                and self.cr.active_count == 0)


class _TenantClass:
    """One priority class inside ``FairBatcher``: a head lane for
    requeued work plus per-tenant FIFO queues under deficit round-robin."""

    __slots__ = ("head", "queues", "rotation", "deficit", "count")

    def __init__(self) -> None:
        self.head: Deque[Request] = deque()
        self.queues: Dict[str, Deque[Request]] = {}
        self.rotation: Deque[str] = deque()    # tenants with queued work
        self.deficit: Dict[str, float] = {}
        self.count = 0


class FairBatcher(Batcher):
    """Weighted per-tenant fairness under the strict priority classes.

    Ordering: strict ``config.priority`` classes first (identical to the
    base ``Batcher``), then — *within* a class — weighted deficit round
    robin (DRR) across tenants, with a request's cost its ``max_tokens``
    budget. Each rotation visit grants a tenant ``quantum * weight``
    token-credits; a tenant whose front request costs more saves its
    deficit for the next visit, so over time admitted token-budget
    converges to the weight ratios while cheap-request tenants still
    can't be starved by expensive-request ones.

    ``requeue`` bypasses fairness entirely: a request returned at the
    head of its class (capacity deferral, replica-death failover) already
    charged its tenant's deficit when first admitted — it pops before any
    DRR lane next time.

    Weights default to 1.0 per tenant (``weights=`` overrides per name;
    must be > 0). Same single-consumer rule as ``Batcher``: queue state
    is only touched on the loop thread.
    """

    def __init__(self, engine: Engine, *,
                 weights: Optional[Dict[str, float]] = None,
                 quantum: float = 32.0,
                 on_drop: Optional[Callable[[Request], None]] = None) -> None:
        super().__init__(engine, on_drop=on_drop)
        self.weights: Dict[str, float] = dict(weights or {})
        for tenant, w in self.weights.items():
            if not float(w) > 0.0:
                raise ValueError(
                    f"tenant weight must be > 0, got {tenant!r}: {w}")
        self.quantum = float(quantum)
        if self.quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        self._classes: Dict[int, _TenantClass] = {}
        self._total = 0
        self.tenant_stats: Dict[str, Dict[str, int]] = {}

    def weight(self, tenant: str) -> float:
        return float(self.weights.get(tenant, 1.0))

    def _tenant_stat(self, tenant: str) -> Dict[str, int]:
        s = self.tenant_stats.get(tenant)
        if s is None:
            s = self.tenant_stats[tenant] = {
                "submitted": 0, "admitted": 0, "admitted_tokens": 0}
        return s

    # ------------------------------------------------------- queue hooks
    def _push(self, request: Request) -> None:
        cls = self._classes.setdefault(request.priority, _TenantClass())
        tenant = request.tenant
        q = cls.queues.get(tenant)
        if q is None:
            q = cls.queues[tenant] = deque()
            cls.deficit.setdefault(tenant, 0.0)
        if not q and tenant not in cls.rotation:
            cls.rotation.append(tenant)
        q.append(request)
        cls.count += 1
        self._total += 1
        self._tenant_stat(tenant)["submitted"] += 1

    def _push_head(self, request: Request) -> None:
        cls = self._classes.setdefault(request.priority, _TenantClass())
        cls.head.appendleft(request)
        cls.count += 1
        self._total += 1

    def _pop(self) -> Optional[Request]:
        if self._total == 0:
            return None
        for prio in sorted(self._classes, reverse=True):
            cls = self._classes[prio]
            if cls.count == 0:
                continue
            req = self._pop_class(cls)
            if req is not None:
                cls.count -= 1
                self._total -= 1
                return req
        return None

    def _pop_class(self, cls: _TenantClass) -> Optional[Request]:
        if cls.head:
            return cls.head.popleft()
        # DRR: visit tenants in rotation order; each visit adds
        # quantum*weight credit, and a tenant spends credit equal to the
        # popped request's token budget. Terminates: every full rotation
        # strictly grows the richest tenant's deficit past any fixed cost.
        while cls.rotation:
            tenant = cls.rotation[0]
            q = cls.queues.get(tenant)
            if not q:
                cls.rotation.popleft()
                continue
            cost = float(q[0].max_new_tokens)
            if cls.deficit[tenant] >= cost:
                cls.deficit[tenant] -= cost
                req = q.popleft()
                if not q:
                    cls.rotation.popleft()
                    # an emptied lane forfeits leftover credit — otherwise
                    # an idle tenant banks unbounded credit and bursts
                    cls.deficit[tenant] = 0.0
                stat = self._tenant_stat(tenant)
                stat["admitted"] += 1
                stat["admitted_tokens"] += int(cost)
                return req
            cls.deficit[tenant] += self.quantum * self.weight(tenant)
            cls.rotation.rotate(-1)
        return None

    def _queue_len(self) -> int:
        return self._total

"""Event taxonomy for the observability subsystem.

Every trace record is a small tuple pushed into a per-thread ring buffer
(``obs.buffer.TraceBuffer``); this module names the event *kinds* and the
lifecycle *edges* so producers and exporters agree on vocabulary without
importing each other.

Two families:

* ``cont.*`` — the four continuation lifecycle edges the paper's latency
  claim is about: an operation is *posted* (continuation registered),
  the op group *completes* (continuation flips READY), the continuation
  is *enqueued* (CR private queue or scheduler ready queue), and the
  callback *runs*. Inter-edge latencies feed per-policy histograms
  (``LIFECYCLE_EDGES``).
* ``req.*`` — serve-layer span/instant events correlated by request id:
  admission, page alloc/release, prefill chunks, KV-block ship/import
  across the disagg transport, decode-step completion, token delivery,
  and the router's shadow-replay link (``req.link`` lets the exporter
  merge a shadow's events onto the original request's track).

Beside them, spans of the serve loop and the trainer that say what the
host was doing (``engine.*``, ``data.wait``, ``train.dispatch``: host
seconds), and ``dev.*``, whose ``ts`` is the host's dispatch stamp and
whose ``dur`` is **device** seconds: the device clock between a pair of
CUDA timing events around the work on its stream (recorded only while
tracing, and only on a card). That is the work's span on the stream, so
it holds the stream's waits for the host too: none inside a graph
replay, many in an eager prefill the host enqueues slower than the card
runs it. ``Tracer.to_unix`` puts a stamp on ``torch.profiler``'s clock.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, NamedTuple, Optional

# --------------------------------------------------------------- kinds
# continuation lifecycle (rid = continuation seqno)
CONT_POSTED = "cont.posted"
CONT_READY = "cont.ready"          # op group complete -> READY
CONT_ENQUEUED = "cont.enqueued"    # pushed to a ready queue
CONT_RAN = "cont.ran"              # span: callback execution
PROGRESS_SCAN = "progress.scan"    # span: a poll scan that found work

# serve layer (rid = request id)
REQ_SUBMIT = "req.submit"          # entered a tier's intake
REQ_ADMIT = "req.admit"            # span: arrival -> placed/seated
REQ_PAGES_ALLOC = "req.pages.alloc"
REQ_PAGES_RELEASE = "req.pages.release"
REQ_PREFILL = "req.prefill"        # span: prefill dispatch -> complete
REQ_KV_SHIP = "req.kv.ship"        # disagg: block left the prefill role
REQ_KV_IMPORT = "req.kv.import"    # disagg: block installed at decode
REQ_SEAT = "req.seat"              # disagg: landed request seated
REQ_STEP = "req.step"              # span: decode/verify step for this req
REQ_DELIVER = "req.deliver"        # tokens published to the request
REQ_FINISH = "req.finish"          # terminal state reached
REQ_LINK = "req.link"              # rid = shadow id, meta = original id
REQ_REPLAY = "req.replay"          # failover: requeued for replay

# serve loop (host spans; rid = -1, or the request id for a prefill)
ENGINE_PREFILL = "engine.prefill"  # span: a placement's enqueue; meta=plen
ENGINE_DISPATCH = "engine.dispatch"  # span: a decode/verify step's enqueue
# device time (ts = host dispatch stamp, dur = DEVICE seconds)
DEV_STEP = "dev.step"              # a decode/verify graph replay; meta=live
DEV_PREFILL = "dev.prefill"        # a prefill on the stream; meta=plen

# trainer (host spans, rid = -1)
DATA_WAIT = "data.wait"            # span: get_next waited for its batch
TRAIN_DISPATCH = "train.dispatch"  # span: a train step's enqueue

#: lifecycle-edge histogram names, in causal order. ``complete_to_run``
#: is the paper's notification latency (op complete -> callback ran).
EDGE_POST_TO_COMPLETE = "post_to_complete"
EDGE_COMPLETE_TO_ENQUEUE = "complete_to_enqueue"
EDGE_ENQUEUE_TO_RUN = "enqueue_to_run"
EDGE_COMPLETE_TO_RUN = "complete_to_run"
LIFECYCLE_EDGES = (EDGE_POST_TO_COMPLETE, EDGE_COMPLETE_TO_ENQUEUE,
                   EDGE_ENQUEUE_TO_RUN, EDGE_COMPLETE_TO_RUN)


class Event(NamedTuple):
    """A drained trace record (ring buffers store the raw 6-tuple)."""

    ts: float            # monotonic seconds (tracer clock)
    dur: float           # span duration in seconds; 0.0 for instants
    kind: str            # one of the constants above
    rid: int             # request id / continuation seqno; -1 if n/a
    src: str             # emitting component ("core", "engine", ...)
    meta: Any            # small per-kind payload (tuple/str/int/None)
    tid: int             # OS thread id of the recording thread


@lru_cache(maxsize=256)
def policy_key(policy) -> str:
    """Compact label for a ``ResolvedPolicy`` — the histogram axis.

    Cached per (frozen, hashable) policy instance; the serve engine's
    bounded ``_step_flags`` cache keeps the population small.
    """
    parts = ["poll" if policy.poll_only else "sched"]
    if policy.thread != "application":
        parts.append(policy.thread)
    if policy.enqueue_complete:
        parts.append("enq")
    if policy.defer_complete:
        parts.append("defer")
    if policy.immediate:
        parts.append("imm")
    if policy.priority:
        parts.append(f"pr{policy.priority}")
    return "|".join(parts)


def link_roots(events) -> dict:
    """Resolve ``req.link`` chains to each request's original id.

    Router failover may re-shadow a shadow; follow links transitively so
    every replayed generation collapses onto one correlated track.
    """
    parent: dict[int, int] = {}
    for ev in events:
        if ev.kind == REQ_LINK and isinstance(ev.meta, int):
            parent[ev.rid] = ev.meta

    def root(rid: int) -> int:
        seen = set()
        while rid in parent and rid not in seen:
            seen.add(rid)
            rid = parent[rid]
        return rid

    return {rid: root(rid) for rid in parent}

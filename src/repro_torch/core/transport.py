"""In-process multi-rank message transport.

The container is a single process, so "ranks" are threads and the network is
a set of mailboxes with MPI-style two-sided matching (source/tag, wildcards,
non-overtaking per (src,dst,tag)). Semantics kept from MPI where they matter
to the paper:

* non-blocking ``isend``/``irecv`` returning completable ops,
* eager vs. rendezvous send completion (``eager_threshold``),
* receive cancellation (→ cancelled status observed by callbacks,
  paper Listing 4),
* completion discovered *inside* a transport call fires continuation hooks on
  the calling thread — the analogue of "continuations may be invoked as soon
  as any thread calls into MPI" (paper §3),
* optional simulated link latency via a background delivery thread, so
  completions are genuinely asynchronous in benchmarks.

One change from the reference: a payload that is, or holds, a CUDA tensor
(directly, or in a tuple, list, dict or dataclass field, nested). The
sender has only *queued* the kernels that write it, and the receiver
reads it on another stream. So ``isend`` records a ``TensorOp`` (a CUDA
event) on the sender's current stream, and the message becomes matchable
only once that op completes: found by polling like every other device
completion (the engine's poll scans, and every transport call or test of
a message op), with the delivery run as the op's ready hook. No host
thread waits and no stream waits on another; a send of a device buffer
completes, as in MPI, once its data is ready. Messages a held one would
overtake wait behind it: delivery keeps post order per (source, dest).
The receiver calls ``take(payload, stream)`` before it queues work on a
received tensor, so the caching allocator does not hand the block back to
the sender's stream while that work is still queued. A payload with no
CUDA tensor is delivered exactly as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.core.completable import Completable, TensorOp
from repro_torch.core.status import OpState, Status

ANY_SOURCE = -1
ANY_TAG = -1


def _payload_nbytes(payload: Any) -> int:
    """Wire size of a payload for eager/rendezvous choice and accounting.

    Array-likes report their ``nbytes`` (typed messages may expose a
    computed ``nbytes`` property covering their array fields); containers
    sum their elements plus a small framing constant, so a KV-block
    message carried as a dict/tuple of device arrays is accounted at its
    real payload size rather than the control-message default."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return len(payload)
    nbytes = getattr(payload, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(payload, (list, tuple)):
        return 16 + sum(_payload_nbytes(v) for v in payload)
    if isinstance(payload, dict):
        return 16 + sum(_payload_nbytes(v) for v in payload.values())
    return 64  # control-message default


def _tensors(payload: Any) -> List[torch.Tensor]:
    """The tensors in a payload: a tensor, or a tuple, list, dict or
    dataclass instance (a typed message such as a KV block) holding
    tensors, nested."""
    if isinstance(payload, torch.Tensor):
        return [payload]
    if isinstance(payload, (list, tuple)):
        return [t for v in payload for t in _tensors(v)]
    if isinstance(payload, dict):
        return [t for v in payload.values() for t in _tensors(v)]
    if dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        return [t for f in dataclasses.fields(payload)
                for t in _tensors(getattr(payload, f.name))]
    return []


def _cuda_tensors(payload: Any) -> List[torch.Tensor]:
    """The CUDA tensors in a payload (see ``_tensors``)."""
    return [t for t in _tensors(payload) if t.is_cuda]


def take(payload: Any, stream: Optional[torch.cuda.Stream] = None) -> Any:
    """Claim a received payload for work queued on ``stream`` (default:
    the calling thread's current stream): each CUDA tensor in it records
    that stream, so its block is not reused until that stream's work
    queued so far has run. Returns ``payload``; a no-op on the CPU."""
    for t in _cuda_tensors(payload):
        t.record_stream(stream if stream is not None
                        else torch.cuda.current_stream(t.device))
    return payload


class MessageOp(Completable):
    """Base for send/recv handles."""

    def __init__(self, transport: "Transport") -> None:
        super().__init__()
        self._transport = transport

    def _poll(self) -> bool:
        # Message completion is push-based (delivered by the matcher);
        # testing one progresses the transport, as MPI_Test does, so a
        # held device message is released even when nothing else polls.
        self._transport._progress()
        return self._state is not OpState.PENDING

    @property
    def supports_push(self) -> bool:
        return True


class SendOp(MessageOp):
    def __init__(self, transport: "Transport", source: int, dest: int,
                 tag: int, payload: Any) -> None:
        super().__init__(transport)
        self.source, self.dest, self.tag = source, dest, tag
        self.payload = payload
        self.nbytes = _payload_nbytes(payload)


class RecvOp(MessageOp):
    def __init__(self, transport: "Transport", rank: int, source: int,
                 tag: int) -> None:
        super().__init__(transport)
        self.rank, self.source, self.tag = rank, source, tag

    def matches(self, src: int, tag: int) -> bool:
        return ((self.source == ANY_SOURCE or self.source == src)
                and (self.tag == ANY_TAG or self.tag == tag))

    def cancel(self) -> bool:
        """Remove a posted receive (paper §3.6); no-op if already matched.

        Complete-or-cancel is atomic against a concurrent ``_deliver``:
        either this call wins the matching race and the op completes
        CANCELLED, or the matcher won — in which case cancel() waits for
        the in-flight ``_finish_pair`` to publish the completion before
        returning False, so the caller never observes a receive that is
        neither matched nor cancelled. (The matcher removes the op from
        the posted list under the mailbox lock but completes it *after*
        releasing the lock; without the wait, a cancel landing in that
        window would return False while the op still reads PENDING.)"""
        if self._transport._cancel_recv(self):
            return self._complete(Status(cancelled=True), OpState.CANCELLED)
        # Not in the posted list: either already terminal, or popped by a
        # matcher whose _finish_pair has not run yet. Wait it out — the
        # matcher completes the op promptly and never blocks on us.
        while self.state is OpState.PENDING:
            time.sleep(1e-6)
        return False


class _Mailbox:
    """Per-rank matching state: posted receives + unexpected messages."""

    __slots__ = ("lock", "posted", "unexpected")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.posted: List[RecvOp] = []
        self.unexpected: List[SendOp] = []


class Transport:
    def __init__(self, n_ranks: int, *, engine=None,
                 eager_threshold: int = 4096,
                 latency_s: float = 0.0) -> None:
        self.n_ranks = n_ranks
        self.engine = engine
        self.eager_threshold = eager_threshold
        self.latency_s = latency_s
        self._boxes = [_Mailbox() for _ in range(n_ranks)]
        self._stats_lock = threading.Lock()
        # device_sends_pending: device sends whose payload was still being
        # written when they were posted (their TensorOp's first poll)
        self._counters = {"sends": 0, "recvs": 0, "matches": 0,
                          "cancelled": 0, "device_sends": 0,
                          "device_sends_pending": 0}
        # per-tag traffic accounting: tag -> sent/received message and
        # byte counters (bytes via _payload_nbytes), so e.g. KV-shipping
        # bandwidth is observable per channel through stats()
        self._tag_counters: dict = {}
        # sends held until their device payload is ready, and any send
        # posted behind one: (source, dest) -> FIFO of (send, ready op).
        # A channel in ``_draining`` is being released by one thread.
        self._held: Dict[Tuple[int, int],
                         Deque[Tuple["SendOp", Optional[TensorOp]]]] = {}
        self._draining: set = set()
        self._held_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._delivery: Optional[threading.Thread] = None
        if latency_s > 0:
            self._dq: list = []
            self._dq_seq = itertools.count()
            self._dq_lock = threading.Lock()
            self._dq_cv = threading.Condition(self._dq_lock)
            self._delivery = threading.Thread(
                target=self._delivery_loop, name="transport-delivery",
                daemon=True)
            self._delivery.start()

    # ------------------------------------------------------------------- API
    def isend(self, source: int, dest: int, tag: int, payload: Any) -> SendOp:
        op = SendOp(self, source, dest, tag, payload)
        with self._stats_lock:
            self._counters["sends"] += 1
            t = self._tag_counter(tag)
            t["sent_msgs"] += 1
            t["sent_bytes"] += op.nbytes
        tensors = _cuda_tensors(payload)
        ready = TensorOp(tensors[0]) if tensors else None
        # poll once at post: ``PENDING_AT_FIRST_POLL`` then counts the
        # sends posted before their data was ready (the release below
        # polls only a channel's head)
        pending = ready is not None and not ready.done()
        key = (source, dest)
        with self._held_lock:
            hold = ready is not None or key in self._held
            if hold:
                self._held.setdefault(key, collections.deque()).append(
                    (op, ready))
        if not hold:
            self._route(op)
        else:
            if ready is not None:
                with self._stats_lock:
                    self._counters["device_sends"] += 1
                    self._counters["device_sends_pending"] += pending
                ready.add_ready_hook(lambda _op, _st: self._release(key))
                if self.engine is not None:
                    self.engine.progress.watch(ready)
            self._release(key)
        self._on_enter()
        return op

    def irecv(self, rank: int, source: int = ANY_SOURCE,
              tag: int = ANY_TAG) -> RecvOp:
        op = RecvOp(self, rank, source, tag)
        with self._stats_lock:
            self._counters["recvs"] += 1
        box = self._boxes[rank]
        matched: Optional[SendOp] = None
        with box.lock:
            for i, send in enumerate(box.unexpected):
                if op.matches(send.source, send.tag):
                    matched = box.unexpected.pop(i)
                    break
            if matched is None:
                box.posted.append(op)
        if matched is not None:
            self._finish_pair(matched, op)
        self._on_enter()
        return op

    def cancel_posted(self, rank: int, source: int = ANY_SOURCE,
                      tag: int = ANY_TAG) -> int:
        """Cancel every receive posted at ``rank`` matching ``source``/
        ``tag`` (wildcards allowed); returns how many were cancelled.

        The failure-recovery primitive: when a peer is declared dead, its
        partner tears down the standing receives armed for that peer so
        their continuations observe CANCELLED (paper Listing 4) instead
        of waiting forever. Matching is evaluated against the *receive's*
        selectors — a recv posted with ``ANY_SOURCE`` is only swept by a
        wildcard ``source`` here, since a specific dead peer cannot claim
        a receive that other, live peers may still satisfy."""
        box = self._boxes[rank]
        with box.lock:
            victims = [op for op in box.posted
                       if (source == ANY_SOURCE or op.source == source)
                       and (tag == ANY_TAG or op.tag == tag)]
        cancelled = 0
        for op in victims:
            if op.cancel():
                cancelled += 1
        self._on_enter()
        return cancelled

    def send(self, source: int, dest: int, tag: int, payload: Any,
             timeout: float = 30.0) -> None:
        """Blocking convenience send."""
        op = self.isend(source, dest, tag, payload)
        self._block(op, timeout)

    def recv(self, rank: int, source: int = ANY_SOURCE, tag: int = ANY_TAG,
             timeout: float = 30.0) -> Status:
        op = self.irecv(rank, source, tag)
        self._block(op, timeout)
        return op.status

    # -------------------------------------------------------------- internals
    def _block(self, op: Completable, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while op.state is OpState.PENDING:
            self._progress()
            if self.engine is not None:
                self.engine.tick()
            if time.monotonic() > deadline:
                raise TimeoutError("transport op timed out")
            time.sleep(1e-5)

    def _on_enter(self) -> None:
        """Run eligible ready continuations — 'thread inside MPI' semantics."""
        self._progress()
        if self.engine is not None:
            self.engine.enter()

    # ------------------------------------------------------ device payloads
    def _route(self, send: SendOp) -> None:
        """Hand a matchable send to the network (after the link latency)."""
        if self.latency_s > 0:
            with self._dq_cv:
                heapq.heappush(self._dq, (time.monotonic() + self.latency_s,
                                          next(self._dq_seq), send))
                self._dq_cv.notify()
        else:
            self._deliver(send)

    def _progress(self) -> None:
        """Poll the held sends' device ops; deliver what has become ready."""
        if not self._held:
            return
        with self._held_lock:
            keys = list(self._held)
        for key in keys:
            self._release(key)

    def _release(self, key: Tuple[int, int]) -> None:
        """Deliver the ready head of channel ``key``'s held sends, in post
        order, until the head's device op is still running. One thread
        drains a channel at a time; a completion seen while another thread
        held it is picked up by the look after that thread lets go."""
        while True:
            with self._held_lock:
                if key in self._draining or key not in self._held:
                    return
                self._draining.add(key)
            try:
                while True:
                    with self._held_lock:
                        fifo = self._held[key]
                        if not fifo:
                            del self._held[key]
                            break
                        send, ready = fifo[0]
                    if ready is not None and not ready.done():
                        break
                    self._route(send)
                    with self._held_lock:
                        fifo.popleft()
            finally:
                with self._held_lock:
                    self._draining.discard(key)
                    fifo = self._held.get(key)
                    again = bool(fifo) and (
                        fifo[0][1] is None
                        or fifo[0][1].state is not OpState.PENDING)
            if not again:
                return

    def _deliver(self, send: SendOp) -> None:
        box = self._boxes[send.dest]
        matched: Optional[RecvOp] = None
        with box.lock:
            for i, recv in enumerate(box.posted):
                if recv.matches(send.source, send.tag):
                    matched = box.posted.pop(i)
                    break
            if matched is None:
                box.unexpected.append(send)
        if matched is not None:
            self._finish_pair(send, matched)
        elif send.nbytes <= self.eager_threshold:
            # Eager: buffered by the "network"; sender completes immediately.
            send._complete(Status(source=send.source, tag=send.tag,
                                  count=send.nbytes))

    def _tag_counter(self, tag: int) -> dict:
        """Per-tag counter bucket (caller holds ``_stats_lock``)."""
        c = self._tag_counters.get(tag)
        if c is None:
            c = self._tag_counters[tag] = {
                "sent_msgs": 0, "sent_bytes": 0,
                "recvd_msgs": 0, "recvd_bytes": 0}
        return c

    def stats(self) -> dict:
        """Snapshot of transport counters.

        Top-level op counts (``sends``/``recvs``/``matches``/
        ``cancelled``), total ``sent_bytes``/``recvd_bytes``, and a
        ``per_tag`` map of ``{tag: {sent_msgs, sent_bytes, recvd_msgs,
        recvd_bytes}}``. Received counters tick at match time (delivery),
        sent counters at post time."""
        with self._stats_lock:
            out = dict(self._counters)
            out["per_tag"] = {t: dict(c)
                              for t, c in self._tag_counters.items()}
        out["sent_bytes"] = sum(c["sent_bytes"]
                                for c in out["per_tag"].values())
        out["recvd_bytes"] = sum(c["recvd_bytes"]
                                 for c in out["per_tag"].values())
        return out

    def _finish_pair(self, send: SendOp, recv: RecvOp) -> None:
        with self._stats_lock:
            self._counters["matches"] += 1
            t = self._tag_counter(send.tag)
            t["recvd_msgs"] += 1
            t["recvd_bytes"] += send.nbytes
        recv._complete(Status(source=send.source, tag=send.tag,
                              payload=send.payload, count=send.nbytes))
        send._complete(Status(source=send.source, tag=send.tag,
                              count=send.nbytes))

    def _cancel_recv(self, op: RecvOp) -> bool:
        box = self._boxes[op.rank]
        with box.lock:
            try:
                box.posted.remove(op)
            except ValueError:
                return False
        with self._stats_lock:
            self._counters["cancelled"] += 1
        return True

    def _delivery_loop(self) -> None:
        if self.engine is not None:
            self.engine.register_internal_thread()
        while not self._shutdown.is_set():
            with self._dq_cv:
                while not self._dq and not self._shutdown.is_set():
                    self._dq_cv.wait(timeout=0.05)
                if self._shutdown.is_set():
                    return
                when, _, op = self._dq[0]
                now = time.monotonic()
                if when > now:
                    self._dq_cv.wait(timeout=when - now)
                    continue
                heapq.heappop(self._dq)
            self._deliver(op)

    def shutdown(self) -> None:
        self._shutdown.set()
        if self._delivery is not None:
            with self._dq_cv:
                self._dq_cv.notify_all()
            self._delivery.join(timeout=2.0)

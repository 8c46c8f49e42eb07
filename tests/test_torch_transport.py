"""The port's transport (``repro_torch.core``): the reference's scenarios
run against it unchanged, then what the port adds — a message whose
payload is a CUDA tensor is matchable only once the device work that wrote
it has run.

The CPU has no CUDA tensor and no pending device work, so the held path
runs here through a test double: tensors marked as device payloads, whose
ready op reports "not yet" until the test releases it, and which fails the
test if anything blocks on it. The card cases are in
``tests/test_torch_gpu.py``.
"""
import dataclasses
import random
import sys
import threading
import time
from typing import Any

import numpy as np
import pytest
import torch

from repro_torch.core import (ANY_SOURCE, ANY_TAG, Completable, Engine,
                              OpState, Status, TestsomeManager, Transport)
from repro_torch.core import transport as transport_mod
from repro_torch.core.transport import _payload_nbytes, take


# ------------------------------------------- the reference's scenarios
@pytest.fixture
def engine():
    eng = Engine()
    yield eng
    eng.shutdown()


def test_send_recv_matching():
    tr = Transport(2)
    recv = tr.irecv(1, source=0, tag=5)
    send = tr.isend(0, 1, 5, b"hello")
    assert recv.done() and send.done()
    assert recv.status.payload == b"hello"
    assert recv.status.source == 0 and recv.status.tag == 5


def test_unexpected_message_then_recv():
    tr = Transport(2)
    send = tr.isend(0, 1, 9, b"x" * 10)   # eager: completes buffered
    assert send.done()
    recv = tr.irecv(1, source=ANY_SOURCE, tag=ANY_TAG)
    assert recv.done()
    assert recv.status.tag == 9


def test_rendezvous_send_waits_for_recv():
    tr = Transport(2, eager_threshold=4)
    send = tr.isend(0, 1, 1, b"x" * 100)   # > threshold: rendezvous
    assert not send.done()
    tr.irecv(1)
    assert send.done()


def test_tag_and_source_selectivity():
    tr = Transport(3)
    r_tag2 = tr.irecv(2, source=ANY_SOURCE, tag=2)
    tr.isend(0, 2, 1, b"one")
    assert not r_tag2.done()
    tr.isend(1, 2, 2, b"two")
    assert r_tag2.done()
    assert r_tag2.status.source == 1
    r_any = tr.irecv(2)
    assert r_any.done() and r_any.status.payload == b"one"


def test_fifo_ordering_same_tag():
    tr = Transport(2)
    for i in range(5):
        tr.isend(0, 1, 7, i)
    got = [tr.irecv(1, tag=7).status.payload for _ in range(5)]
    assert got == list(range(5))


def test_recv_cancellation():
    tr = Transport(2)
    recv = tr.irecv(1, source=0, tag=3)
    assert recv.cancel() is True
    assert recv.state is OpState.CANCELLED
    assert recv.status.test_cancelled()
    # a matching send now goes to the unexpected queue, not the cancelled recv
    tr.isend(0, 1, 3, b"late")
    r2 = tr.irecv(1, tag=3)
    assert r2.done() and r2.status.payload == b"late"


def test_cancel_after_match_fails():
    tr = Transport(2)
    recv = tr.irecv(1)
    tr.isend(0, 1, 0, b"m")
    assert recv.cancel() is False
    assert recv.status.payload == b"m"


def test_continuation_on_recv(engine):
    """The paper's central flow: callback fires when the message lands,
    on the thread that made the completing transport call."""
    tr = Transport(2, engine=engine)
    cr = engine.continue_init()
    seen = []
    recv = tr.irecv(1, source=0, tag=1)
    engine.continue_when(recv, lambda st, d: seen.append(st[0].payload),
                         status=[None], cr=cr)
    assert seen == []
    tr.isend(0, 1, 1, b"payload")   # completes recv → continuation inline
    assert seen == [b"payload"]
    assert cr.test()


def test_continuation_repost_from_callback(engine):
    """Paper §2: a continuation body may start new operations (re-post).

    Callbacks run nested-free: the re-posted recv's own continuation fires
    later, not recursively.
    """
    tr = Transport(2, engine=engine)
    cr = engine.continue_init()
    got = []

    def on_msg(st, d):
        got.append(st[0].payload)
        if len(got) < 3:
            nxt = tr.irecv(1, source=0, tag=1)
            engine.continue_when(nxt, on_msg, status=[None], cr=cr)

    first = tr.irecv(1, source=0, tag=1)
    engine.continue_when(first, on_msg, status=[None], cr=cr)
    for i in range(3):
        tr.isend(0, 1, 1, i)
        engine.tick()
    assert cr.wait(timeout=2.0)
    assert got == [0, 1, 2]


def test_latency_delivery(engine):
    tr = Transport(2, engine=engine, latency_s=0.02)
    try:
        cr = engine.continue_init()
        seen = threading.Event()
        recv = tr.irecv(1, source=0, tag=1)
        engine.continue_when(recv, lambda st, d: seen.set(), cr=cr)
        t0 = time.monotonic()
        tr.isend(0, 1, 1, b"delayed")
        assert not seen.is_set()
        assert cr.wait(timeout=2.0)
        assert seen.is_set()
        assert time.monotonic() - t0 >= 0.015
    finally:
        tr.shutdown()


def test_multithreaded_ranks_pingpong(engine):
    """Two 'ranks' on two threads ping-pong via continuations."""
    tr = Transport(2, engine=engine)
    n_rounds = 20
    done = threading.Event()
    log = []

    def rank(rid, peer):
        # enqueue_complete: recv completed before registration still fires the
        # callback via the queue — no immediate-flag handling needed (§3.5).
        cr = engine.continue_init({"mpi_continue_enqueue_complete": True})
        count = {"n": 0}

        def on_msg(st, d):
            log.append((rid, st[0].payload))
            count["n"] += 1
            if st[0].payload < n_rounds:
                tr.isend(rid, peer, 0, st[0].payload + 1)
            nxt = tr.irecv(rid, source=peer, tag=0)
            engine.continue_when(nxt, on_msg, status=[None], cr=cr)

        first = tr.irecv(rid, source=peer, tag=0)
        engine.continue_when(first, on_msg, status=[None], cr=cr)
        if rid == 0:
            tr.isend(0, peer, 0, 0)
        deadline = time.monotonic() + 10
        while count["n"] < n_rounds // 2 and time.monotonic() < deadline:
            engine.tick()
            time.sleep(1e-4)
        done.set()

    t0 = threading.Thread(target=rank, args=(0, 1))
    t1 = threading.Thread(target=rank, args=(1, 0))
    t0.start(); t1.start()
    t0.join(timeout=15); t1.join(timeout=15)
    assert done.is_set()
    payloads = sorted(p for _, p in log)
    assert payloads[0] == 0 and payloads[-1] >= n_rounds - 1


# ------------------------------------------------------ wildcard ordering
def test_wildcard_recv_matches_posted_order():
    """A send must match the FIRST posted recv it satisfies, even when a
    wildcard recv was posted ahead of a more specific one."""
    tr = Transport(2)
    r_any = tr.irecv(1, source=ANY_SOURCE, tag=ANY_TAG)
    r_spec = tr.irecv(1, source=0, tag=4)
    tr.isend(0, 1, 4, b"m1")
    assert r_any.done()               # posted first, wins the match
    assert not r_spec.done()
    assert r_any.status.tag == 4
    tr.isend(0, 1, 4, b"m2")
    assert r_spec.done()
    assert r_spec.status.payload == b"m2"


def test_wildcard_source_only_and_tag_only():
    tr = Transport(3)
    r_src = tr.irecv(2, source=ANY_SOURCE, tag=9)      # any source, tag 9
    r_tag = tr.irecv(2, source=1, tag=ANY_TAG)         # source 1, any tag
    tr.isend(1, 2, 5, b"tagged5")     # only r_tag matches (tag 9 required)
    assert r_tag.done() and not r_src.done()
    assert r_tag.status.source == 1 and r_tag.status.tag == 5
    tr.isend(0, 2, 9, b"tagged9")
    assert r_src.done()
    assert r_src.status.source == 0


def test_wildcard_recv_drains_unexpected_in_arrival_order():
    """ANY/ANY receives must consume unexpected messages FIFO (MPI
    non-overtaking per (src,dst,tag) — and our single mailbox keeps total
    arrival order)."""
    tr = Transport(2)
    for i in range(4):
        tr.isend(0, 1, 10 + i, i)
    got = [tr.irecv(1, source=ANY_SOURCE, tag=ANY_TAG).status.payload
           for i in range(4)]
    assert got == [0, 1, 2, 3]


def test_specific_recv_skips_nonmatching_unexpected():
    tr = Transport(2)
    tr.isend(0, 1, 1, b"first")
    tr.isend(0, 1, 2, b"second")
    r = tr.irecv(1, source=0, tag=2)       # must skip the tag-1 message
    assert r.done() and r.status.payload == b"second"
    r1 = tr.irecv(1)
    assert r1.done() and r1.status.payload == b"first"


# ------------------------------------------------------- cancel-vs-match
def test_cancel_vs_match_race_exactly_one_outcome():
    """Racing cancel() against a matching isend: exactly one of them wins,
    and the message is never lost — if the cancel wins, the payload stays
    available for a later receive."""
    n_iters = 200
    for i in range(n_iters):
        tr = Transport(2)
        recv = tr.irecv(1, source=0, tag=7)
        start = threading.Barrier(2)
        cancel_result = [None]

        def canceller():
            start.wait()
            cancel_result[0] = recv.cancel()

        def sender():
            start.wait()
            tr.isend(0, 1, 7, i)

        ts = [threading.Thread(target=canceller),
              threading.Thread(target=sender)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if cancel_result[0]:
            assert recv.state is OpState.CANCELLED
            assert recv.status.test_cancelled()
            late = tr.irecv(1, source=0, tag=7)   # message not lost
            assert late.done() and late.status.payload == i
        else:
            assert recv.done()
            assert recv.status.payload == i
            assert recv.state is not OpState.CANCELLED


def test_cancel_after_unexpected_match_is_noop():
    tr = Transport(2)
    tr.isend(0, 1, 3, b"early")           # lands unexpected
    recv = tr.irecv(1, source=0, tag=3)   # matches immediately on post
    assert recv.done()
    assert recv.cancel() is False
    assert recv.status.payload == b"early"


def test_double_cancel_is_idempotent():
    tr = Transport(2)
    recv = tr.irecv(1, source=0, tag=3)
    assert recv.cancel() is True
    assert recv.cancel() is False          # already removed + completed
    assert recv.state is OpState.CANCELLED


# ----------------------------------------------------------- rendezvous
def test_rendezvous_completes_only_on_matching_recv():
    tr = Transport(2, eager_threshold=8)
    send = tr.isend(0, 1, 5, b"x" * 64)          # rendezvous-sized
    assert not send.done()
    tr.irecv(1, source=0, tag=6)                 # wrong tag: no match
    assert not send.done()
    tr.irecv(1, source=ANY_SOURCE, tag=5)        # matches
    assert send.done()
    assert send.status.count == 64


def test_rendezvous_ignores_cancelled_recv():
    tr = Transport(2, eager_threshold=8)
    recv = tr.irecv(1, source=0, tag=5)
    assert recv.cancel() is True
    send = tr.isend(0, 1, 5, b"y" * 64)
    assert not send.done()                 # cancelled recv must not match
    r2 = tr.irecv(1, source=0, tag=5)
    assert send.done() and r2.done()
    assert r2.status.payload == b"y" * 64


def test_eager_vs_rendezvous_threshold_boundary():
    tr = Transport(2, eager_threshold=16)
    eager = tr.isend(0, 1, 1, b"e" * 16)         # == threshold: eager
    assert eager.done()
    rendez = tr.isend(0, 1, 1, b"r" * 17)        # > threshold: rendezvous
    assert not rendez.done()
    got = [tr.irecv(1, tag=1).status.payload for _ in range(2)]
    assert got == [b"e" * 16, b"r" * 17]         # FIFO preserved
    assert rendez.done()


# ------------------------------------- cancel vs in-flight _finish_pair
def test_cancel_waits_out_inflight_finish_pair():
    """Regression: the matcher pops a posted recv under the mailbox lock
    but completes it AFTER releasing the lock. A cancel() landing in that
    window used to return False while the op still read PENDING — the
    caller observed a receive that was neither matched nor cancelled.
    cancel() must block until the in-flight completion publishes."""
    tr = Transport(2)
    recv = tr.irecv(1, source=0, tag=11)

    in_window = threading.Event()     # matcher popped recv, not completed
    resume = threading.Event()        # let the matcher finish
    orig_finish = Transport._finish_pair

    def stalled_finish(self, send, r):
        in_window.set()
        assert resume.wait(5.0)
        orig_finish(self, send, r)

    tr._finish_pair = stalled_finish.__get__(tr, Transport)
    sender = threading.Thread(target=tr.isend,
                              args=(0, 1, 11, b"payload"))
    sender.start()
    assert in_window.wait(5.0)

    observed = {}

    def do_cancel():
        observed["result"] = recv.cancel()
        observed["state"] = recv.state

    canceller = threading.Thread(target=do_cancel)
    canceller.start()
    # cancel() must be stuck: the op is out of the posted list but its
    # completion has not published yet
    canceller.join(timeout=0.2)
    assert canceller.is_alive(), "cancel() returned inside the race window"
    resume.set()
    canceller.join(timeout=5.0)
    sender.join(timeout=5.0)
    assert not canceller.is_alive()
    assert observed["result"] is False          # matcher won the race
    assert observed["state"] is OpState.COMPLETE
    assert recv.status.payload == b"payload"


# ------------------------------------------------------- per-tag stats
def test_stats_per_tag_counters():
    tr = Transport(2, eager_threshold=8)
    tr.isend(0, 1, 3, b"abcd")                   # eager, 4 bytes
    tr.isend(0, 1, 3, b"efgh")
    big = tr.isend(0, 1, 5, b"z" * 32)           # rendezvous, unmatched
    s = tr.stats()
    assert s["sends"] == 3 and s["recvs"] == 0
    assert s["per_tag"][3] == {"sent_msgs": 2, "sent_bytes": 8,
                               "recvd_msgs": 0, "recvd_bytes": 0}
    # sent counters tick at post time even before a match
    assert s["per_tag"][5]["sent_msgs"] == 1
    assert s["per_tag"][5]["sent_bytes"] == 32
    assert s["per_tag"][5]["recvd_msgs"] == 0
    assert s["sent_bytes"] == 40 and s["recvd_bytes"] == 0

    tr.irecv(1, source=0, tag=3)
    tr.irecv(1, source=0, tag=5)
    s = tr.stats()
    assert big.done()
    assert s["matches"] == 2
    assert s["per_tag"][3]["recvd_msgs"] == 1    # one of two matched
    assert s["per_tag"][3]["recvd_bytes"] == 4
    assert s["per_tag"][5]["recvd_msgs"] == 1
    assert s["recvd_bytes"] == 36


def test_stats_payload_accounting_containers():
    """Container payloads are accounted at their real element sizes (plus
    framing), not the flat control-message default — typed messages with
    an nbytes property report it directly."""
    tr = Transport(2, eager_threshold=64)
    arr = np.zeros(100, np.int32)                # 400 bytes
    s1 = tr.isend(0, 1, 1, (7, arr))             # tuple: framed sum
    assert not s1.done()                         # > threshold: rendezvous
    assert s1.nbytes >= 400

    class Msg:
        nbytes = 123
    s2 = tr.isend(0, 1, 2, Msg())
    assert s2.nbytes == 123
    d = tr.isend(0, 1, 3, {"k": arr, "v": arr})
    assert d.nbytes >= 800


# ------------------------------------------------------- payload size
def test_payload_nbytes_counts_cpu_tensors():
    """A torch tensor reports its ``nbytes``; containers of tensors are
    framed sums, as for numpy arrays."""
    t = torch.zeros(100, dtype=torch.int32)               # 400 bytes
    assert _payload_nbytes(t) == 400
    assert _payload_nbytes(torch.zeros((3, 5), dtype=torch.float64)) == 120
    assert _payload_nbytes(("tile", t)) == 16 + 64 + 400
    assert _payload_nbytes({"k": t, "v": t}) == 16 + 800
    tr = Transport(2, eager_threshold=256)
    send = tr.isend(0, 1, 1, t)
    assert send.nbytes == 400 and not send.done()          # rendezvous
    recv = tr.irecv(1, source=0, tag=1)
    assert send.done() and recv.status.count == 400
    assert recv.status.payload is t                        # no copy
    assert tr.stats()["device_sends"] == 0


def test_take_is_a_noop_for_cpu_payloads():
    payload = ("tile", torch.ones(4), {"x": torch.zeros(2)})
    assert take(payload) is payload


@dataclasses.dataclass(frozen=True)
class _Block:
    """A typed message shaped like the disaggregated server's KV block."""
    index: int
    k: Any
    v: Any

    @property
    def nbytes(self) -> int:
        return int(self.k.nbytes) + int(self.v.nbytes)


@dataclasses.dataclass
class _Wrapped:
    name: str
    inner: Any


def test_typed_message_tensors_found_and_sized():
    """Tensors in dataclass fields are found, nested in and around
    containers; a typed message is sized by its ``nbytes``."""
    k, v = torch.zeros((2, 4, 3), dtype=torch.float32), torch.ones(5)
    msg = _Block(0, k, v)
    found = transport_mod._tensors(msg)
    assert len(found) == 2 and found[0] is k and found[1] is v
    nested = ("hdr", {"blk": _Wrapped("w", [msg, 3])}, _Wrapped("e", None))
    assert [t is k or t is v for t in transport_mod._tensors(nested)] \
        == [True, True]
    assert transport_mod._tensors(_Block) == []        # the class itself
    assert transport_mod._cuda_tensors(nested) == []   # CPU tensors
    assert _payload_nbytes(msg) == 96 + 20
    tr = Transport(2, eager_threshold=64)
    send = tr.isend(0, 1, 4, msg)
    assert send.nbytes == 116 and not send.done()      # rendezvous
    recv = tr.irecv(1, source=0, tag=4)
    assert send.done() and recv.status.payload is msg
    assert take(msg) is msg
    assert tr.stats()["per_tag"][4]["recvd_bytes"] == 116


# ------------------------------------------------------- TestsomeManager
class _FlagOp(Completable):
    def __init__(self):
        super().__init__()
        self.flag = False

    def _poll(self):
        return self.flag


def test_testsome_window_hides_completions_until_promoted():
    """Only ``window`` ops are tested per pass; a complete op waiting in
    the pending list is not seen until a slot frees and it is promoted
    (the delay the paper measures)."""
    mgr = TestsomeManager(window=2)
    fired = []
    ops = [_FlagOp() for _ in range(4)]
    for i, op in enumerate(ops):
        mgr.submit([op], lambda st, d: fired.append(d), i)
    ops[3].flag = True                       # complete, but pending
    assert mgr.testsome() == 0 and fired == []
    assert mgr.stats["ops_tested"] == 2
    ops[0].flag = True                       # frees a slot: 2 promoted
    assert mgr.testsome() == 1 and fired == [0]
    assert mgr.testsome() == 0               # op 3 still behind op 2
    ops[1].flag = True
    assert mgr.testsome() == 1               # now 3 enters the window
    assert mgr.testsome() == 1 and fired == [0, 1, 3]
    assert mgr.outstanding == 1


def test_testsome_drain_groups_statuses_and_first_k():
    mgr = TestsomeManager(window=3)
    got = {}
    ops = [_FlagOp() for _ in range(5)]
    mgr.submit(ops[:2], lambda st, d: got.__setitem__("all", st), None,
               want_statuses=True)
    idx = []
    mgr.submit_some(ops[2:], 2, lambda st, d: got.__setitem__("some", d),
                    "k", indices_out=idx)
    for op in (ops[4], ops[0], ops[1], ops[2]):
        op.flag = True
    mgr.drain()
    assert mgr.outstanding == 0
    assert len(got["all"]) == 2 and all(isinstance(s, Status)
                                        for s in got["all"])
    assert got["some"] == "k" and sorted(idx) == [0, 2]
    ops[3].flag = True                       # a loser's late completion
    assert mgr.testsome() == 0
    with pytest.raises(ValueError):
        mgr.submit(ops[:1], lambda st, d: None, need=2)


def test_testsome_drives_message_ops():
    tr = Transport(2)
    mgr = TestsomeManager(window=4)
    got = []
    recv = tr.irecv(1, source=0, tag=3)
    mgr.submit([recv], lambda st, d: got.append(st[0].payload),
               want_statuses=True)
    assert mgr.testsome() == 0
    tr.isend(0, 1, 3, b"m")
    mgr.drain()
    assert got == [b"m"]


# ------------------------------------------- device payloads (test double)
class _HeldOp(Completable):
    """Stands in for the ``TensorOp`` a device payload records: pending
    until released; blocking on it fails the test (the transport must
    only poll)."""

    made = []

    def __init__(self, tensor):
        super().__init__()
        self.released = False
        self.polls = 0
        _HeldOp.made.append(self)

    def _poll(self):
        self.polls += 1
        return self.released

    def block(self):
        raise AssertionError("something blocked on a device payload")


@pytest.fixture
def held(monkeypatch):
    """``_DevTensor``s count as device payloads, and their ready op is a
    held-back ``_HeldOp``."""
    _HeldOp.made = []

    def device_tensors(payload):
        if isinstance(payload, torch.Tensor):
            return [payload] if isinstance(payload, _DevTensor) else []
        if isinstance(payload, (list, tuple)):
            return [t for v in payload for t in device_tensors(v)]
        if isinstance(payload, dict):
            return [t for v in payload.values() for t in device_tensors(v)]
        return []

    monkeypatch.setattr(transport_mod, "_cuda_tensors", device_tensors)
    monkeypatch.setattr(transport_mod, "TensorOp", _HeldOp)
    return _HeldOp.made


class _DevTensor(torch.Tensor):
    """A CPU tensor the ``held`` fixture treats as a device payload."""


def _dev(*values):
    return torch.tensor(values, dtype=torch.float64).as_subclass(_DevTensor)


def test_device_payload_matchable_only_when_ready(held):
    tr = Transport(2)
    recv = tr.irecv(1, source=0, tag=1)
    send = tr.isend(0, 1, 1, ("halo", _dev(1.0, 2.0)))
    assert len(held) == 1 and tr.stats()["device_sends"] == 1
    for _ in range(3):                  # polled, never waited on
        assert not recv.done() and not send.done()
    assert held[0].polls >= 3
    held[0].released = True
    assert recv.done() and send.done()  # testing the recv progresses it
    assert recv.status.payload[1].tolist() == [1.0, 2.0]


def test_held_message_keeps_post_order_per_channel(held):
    """Non-overtaking: a CPU message posted behind a held device message
    on the same (source, dest) waits for it; other channels do not."""
    tr = Transport(3)
    tr.isend(0, 2, 5, _dev(1.0))
    tr.isend(0, 2, 6, b"control")       # CPU, but behind the held one
    tr.isend(1, 2, 7, b"other channel")
    first = tr.irecv(2, source=ANY_SOURCE, tag=ANY_TAG)
    assert first.done() and first.status.payload == b"other channel"
    r_ctrl = tr.irecv(2, source=0, tag=6)
    assert not r_ctrl.done()
    held[0].released = True
    r_any = tr.irecv(2, source=0, tag=ANY_TAG)
    assert r_any.done() and r_any.status.tag == 5   # arrived first
    assert r_ctrl.done() and r_ctrl.status.payload == b"control"
    assert tr._held == {}


def test_held_messages_release_in_post_order_whatever_order_ready(held):
    tr = Transport(2)
    for i in range(4):
        tr.isend(0, 1, 9, _dev(float(i)))
    held[2].released = True
    held[3].released = True
    r = tr.irecv(1, source=0, tag=9)
    assert not r.done()                 # the head (0) is still running
    held[0].released = True
    held[1].released = True
    assert r.done()
    got = [r.status.payload] + [tr.irecv(1, source=0, tag=9).status.payload
                                for _ in range(3)]
    assert [float(t) for t in got] == [0.0, 1.0, 2.0, 3.0]


def test_engine_poll_scan_delivers_held_message(held, engine):
    """The engine's progress scan finds the ready op and runs the
    delivery, so a continuation on the receive fires with no further
    transport call (a rank that only calls ``cr.test()``)."""
    tr = Transport(2, engine=engine)
    cr = engine.continue_init()
    seen = []
    recv = tr.irecv(1, source=0, tag=1)
    engine.continue_when(recv, lambda st, d: seen.append(st[0].payload),
                         status=[None], cr=cr)
    tr.isend(0, 1, 1, _dev(3.0))
    cr.test()
    assert seen == []
    held[0].released = True
    assert cr.wait(timeout=2.0)
    assert len(seen) == 1 and float(seen[0]) == 3.0


def test_held_message_with_latency_and_blocking_send(held, engine):
    tr = Transport(2, engine=engine, latency_s=0.01)
    try:
        out = {}

        def sender():
            out["t0"] = time.monotonic()
            tr.send(0, 1, 4, _dev(5.0), timeout=5.0)   # blocks until ready
            out["t1"] = time.monotonic()

        th = threading.Thread(target=sender)
        th.start()
        deadline = time.monotonic() + 5.0
        while not held and time.monotonic() < deadline:
            time.sleep(1e-3)
        assert held, "the sender never posted"
        time.sleep(0.02)
        assert th.is_alive()                 # payload not ready: not sent
        held[0].released = True
        st = tr.recv(1, source=0, tag=4, timeout=5.0)
        th.join(timeout=5.0)
        assert not th.is_alive()
        assert float(st.payload) == 5.0
        assert out["t1"] - out["t0"] >= 0.02
    finally:
        tr.shutdown()


def test_held_messages_stress_keep_channel_order(held):
    """Four sender threads interleave device and CPU messages to one
    receiver while another thread releases the device ops in random
    order: every channel still arrives in post order, nothing is lost."""
    tr = Transport(5)
    n_msgs = 60
    stop = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def sender(src):
            for i in range(n_msgs):
                payload = _dev(float(i)) if i % 3 else (src, i)
                tr.isend(src, 4, 100 + src, payload)

        def releaser():
            rng = random.Random(0)
            while not stop.is_set():
                pending = [op for op in list(held) if not op.released]
                if pending:
                    rng.choice(pending).released = True
                tr._progress()

        threads = [threading.Thread(target=sender, args=(s,))
                   for s in range(4)]
        rel = threading.Thread(target=releaser)
        rel.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        got = {s: [] for s in range(4)}
        deadline = time.monotonic() + 30
        while sum(map(len, got.values())) < 4 * n_msgs \
                and time.monotonic() < deadline:
            r = tr.irecv(4, source=ANY_SOURCE, tag=ANY_TAG)
            while not r.done() and time.monotonic() < deadline:
                pass
            p = r.status.payload
            got[r.status.source].append(
                int(p) if isinstance(p, torch.Tensor) else p[1])
        stop.set()
        rel.join(timeout=10)
        assert not rel.is_alive()
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        stop.set()
    assert got == {s: list(range(n_msgs)) for s in range(4)}


def test_typed_message_held_until_its_tensors_are_written(held,
                                                          monkeypatch):
    """A dataclass message whose fields hold device tensors is held like a
    tuple of them: matchable only once its ``TensorOp`` completes, and a
    control message behind it on the channel waits."""
    monkeypatch.setattr(
        transport_mod, "_cuda_tensors",
        lambda p: [t for t in transport_mod._tensors(p)
                   if isinstance(t, _DevTensor)])
    tr = Transport(2)
    recv = tr.irecv(1, source=0, tag=1)
    tr.isend(0, 1, 1, _Block(0, _dev(1.0), _dev(2.0, 3.0)))
    tr.isend(0, 1, 2, b"done")
    ctrl = tr.irecv(1, source=0, tag=2)
    assert len(held) == 1 and tr.stats()["device_sends"] == 1
    assert tr.stats()["device_sends_pending"] == 1
    for _ in range(3):
        assert not recv.done() and not ctrl.done()
    held[0].released = True
    assert recv.done() and ctrl.done()
    assert recv.status.payload.v.tolist() == [2.0, 3.0]

"""The paper's three applications in the port (``repro_torch.zones``,
``repro_torch.dataflow``, ``repro_torch.runtime``) against the JAX
package's own functions on the same seeded inputs, on the CPU.

The zones solver must be bit-identical to the reference (the port keeps
its operation order, and every fp64 add and multiply is correctly
rounded); tiled Cholesky agrees to 1e-10 (LAPACK's general solve in the
reference, a triangular solve in the port); offload results equal
``payload * 2 + 1`` as the reference's do. The heartbeat scenarios are
the reference's, run against the port's copy.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import Engine as RefEngine
from repro.core import Transport as RefTransport
from repro.dataflow import cholesky as ref_chol
from repro.dataflow import runtime as ref_df
from repro.runtime import offload as ref_off
from repro.zones import solver as ref_zones
from repro_torch.core import Engine, Transport
from repro_torch.dataflow import (ContinuationBackend, TestsomeBackend,
                                  assemble_result, build_cholesky_graph,
                                  make_spd_matrix, potrf_failures,
                                  run_dataflow)
from repro_torch.runtime.heartbeat import HeartbeatMonitor, HeartbeatSender
from repro_torch.runtime.offload import (ContinuationBackend as OffCont,
                                         OffloadManager, run_offload)
from repro_torch.runtime.offload import TestsomeBackend as OffTestsome
from repro_torch.zones import distributed_solve, make_zones, reference_solve

CHOLESKY_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def engine():
    eng = Engine()
    yield eng
    eng.shutdown()


def _bit_identical(got, want):
    return len(got) == len(want) and all(
        torch.equal(g, torch.from_numpy(w)) for g, w in zip(got, want))


# ------------------------------------------------------------------ zones
@pytest.fixture(scope="module")
def zones_ref():
    zones = ref_zones.make_zones(n_zones=6, ny=16, base_nx=8, seed=1)
    return zones, ref_zones.reference_solve(zones, timesteps=5)


@pytest.mark.parametrize("smooth_iters", [1, 2])
def test_zones_make_and_reference_solve_bit_identical(smooth_iters):
    want_zones = ref_zones.make_zones(n_zones=6, ny=16, base_nx=8, seed=1)
    zones = make_zones(6, 16, 8, seed=1, device="cpu")
    assert _bit_identical(zones, want_zones)
    assert all(z.dtype == torch.float64 for z in zones)
    got = reference_solve(zones, 5, smooth_iters)
    assert _bit_identical(got, ref_zones.reference_solve(
        want_zones, 5, smooth_iters))


@pytest.mark.parametrize("variant", ["fork_join", "continuations"])
@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_zones_distributed_bit_identical_to_reference(zones_ref, variant,
                                                      n_ranks):
    ref_input, want = zones_ref
    zones = make_zones(6, 16, 8, seed=1, device="cpu")
    got, timings = distributed_solve(zones, n_ranks=n_ranks, timesteps=5,
                                     variant=variant)
    assert _bit_identical(got, want)
    ref_got, _ = ref_zones.distributed_solve(ref_input, n_ranks=n_ranks,
                                             timesteps=5, variant=variant)
    assert _bit_identical(got, ref_got)
    assert set(timings) == {"elapsed", "wait", "compute"}
    # the input zones are the caller's and stay untouched
    assert _bit_identical(zones, ref_input)


# --------------------------------------------------------------- Cholesky
def _ref_cholesky(n_ranks, nb, tile, seed=2):
    A = ref_chol.make_spd_matrix(nb * tile, seed=seed)
    graph, meta = ref_chol.build_cholesky_graph(A, nb, tile, n_ranks)
    tiles, _ = ref_df.run_dataflow(
        graph, lambda eng: ref_df.ContinuationBackend(eng), timeout=60)
    return ref_chol.assemble_result(tiles, meta)


@pytest.mark.parametrize("backend", ["continuations", "testsome"])
@pytest.mark.parametrize("n_ranks,nb,tile", [(2, 4, 8), (4, 5, 8)])
def test_dataflow_cholesky_matches_reference(backend, n_ranks, nb, tile):
    A = make_spd_matrix(nb * tile, seed=2, device="cpu")
    np.testing.assert_array_equal(
        A.numpy(), ref_chol.make_spd_matrix(nb * tile, seed=2))
    graph, meta = build_cholesky_graph(A, nb, tile, n_ranks)
    factory = (lambda eng: ContinuationBackend(eng)) \
        if backend == "continuations" else (lambda eng: TestsomeBackend(8))
    tiles, stats = run_dataflow(graph, factory, timeout=60)
    L = assemble_result(tiles, meta)
    want = _ref_cholesky(n_ranks, nb, tile)
    assert L.dtype == torch.float64
    assert np.abs(L.numpy() - want).max() <= CHOLESKY_TOL
    assert stats["executed"] == len(graph.tasks)
    assert potrf_failures(meta) == 0 and len(meta["info"]) == nb


def test_dataflow_single_rank():
    A = make_spd_matrix(24, seed=3, device="cpu")
    graph, meta = build_cholesky_graph(A, 3, 8, 1)
    tiles, _ = run_dataflow(graph, lambda eng: ContinuationBackend(eng))
    want = ref_chol.make_spd_matrix(24, seed=3)
    ref_graph, ref_meta = ref_chol.build_cholesky_graph(want, 3, 8, 1)
    ref_tiles, _ = ref_df.run_dataflow(
        ref_graph, lambda eng: ref_df.ContinuationBackend(eng))
    got = assemble_result(tiles, meta).numpy()
    assert np.abs(got - ref_chol.assemble_result(ref_tiles, ref_meta)
                  ).max() <= CHOLESKY_TOL
    assert np.abs(got - np.linalg.cholesky(want)).max() <= CHOLESKY_TOL


def test_potrf_failures_counts_a_matrix_not_positive_definite():
    """POTRF does not wait to check ``info``; the failure shows after the
    run, where the reference would have raised inside the task."""
    A = -torch.eye(16, dtype=torch.float64)
    graph, meta = build_cholesky_graph(A, 2, 8, 2)
    run_dataflow(graph, lambda eng: ContinuationBackend(eng), timeout=60)
    assert potrf_failures(meta) == 2


# ---------------------------------------------------------------- offload
@pytest.mark.parametrize("backend_kind", ["continuations", "testsome"])
def test_offload_roundtrip(engine, backend_kind):
    """A task offloaded from rank 0 to rank 1 returns the computed result
    through the 2-out/3-back message group, equal to the reference's for
    the same task."""
    tr = Transport(2, engine=engine)
    if backend_kind == "continuations":
        b0, b1 = OffCont(engine), OffCont(engine)
    else:
        b0, b1 = OffTestsome(8), OffTestsome(8)
    m0 = OffloadManager(0, 2, tr, b0, device="cpu")
    m1 = OffloadManager(1, 2, tr, b1, device="cpu")
    task = m0.new_task(cost_s=0.001)
    m0.offload(task, target=1)
    deadline = time.monotonic() + 5.0
    while not task.done.is_set() and time.monotonic() < deadline:
        b0.progress(); b1.progress()
        time.sleep(1e-4)
    assert task.done.is_set()
    assert torch.equal(task.result, task.payload * 2 + 1)
    assert m1.stats["executed_remote"] == 1
    assert m0.stats["returned"] == 1
    m0.stop(); m1.stop()

    ref_engine = RefEngine()
    try:
        ref_tr = RefTransport(2, engine=ref_engine)
        make = (lambda: ref_off.ContinuationBackend(ref_engine)) \
            if backend_kind == "continuations" \
            else (lambda: ref_off.TestsomeBackend(8))
        r0, r1 = make(), make()
        rm0 = ref_off.OffloadManager(0, 2, ref_tr, r0)
        rm1 = ref_off.OffloadManager(1, 2, ref_tr, r1)
        ref_task = rm0.new_task(cost_s=0.001)
        rm0.offload(ref_task, target=1)
        deadline = time.monotonic() + 5.0
        while not ref_task.done.is_set() and time.monotonic() < deadline:
            r0.progress(); r1.progress()
            time.sleep(1e-4)
        assert ref_task.task_id == task.task_id
        np.testing.assert_array_equal(task.result.numpy(), ref_task.result)
        rm0.stop(); rm1.stop()
    finally:
        ref_engine.shutdown()


def test_offload_quota_dynamics(engine):
    tr = Transport(2, engine=engine)
    m0 = OffloadManager(0, 2, tr, OffCont(engine), device="cpu")
    q0 = m0.quota[1]
    m0.end_iteration({1: False})
    assert m0.quota[1] == q0 + 1
    m0.end_iteration({1: True})       # emergency
    assert m0.quota[1] == max(1, (q0 + 1) // 2)
    assert m0.suspended[1] == 3
    assert m0.pick_target({1: 0.0}) is None   # suspended
    for _ in range(3):
        m0.end_iteration({})
    assert m0.pick_target({1: 0.0}) == 1


@pytest.mark.parametrize("backend,offloading", [
    ("continuations", True), ("testsome", True), ("continuations", False)])
def test_run_offload_results(backend, offloading):
    """The paper's experiment at 2 iterations: every task's result is
    ``payload * 2 + 1``, wherever it ran; rank 0 offloads only when
    asked to."""
    out = run_offload(backend, offloading=offloading, iters=2,
                      task_cost_s=0.001, device="cpu")
    assert len(out["tasks"]) == 2 * (6 * 8 + 3 * 8)
    assert all(t.done.is_set() and torch.equal(t.result, t.payload * 2 + 1)
               for t in out["tasks"])
    assert (out["offloaded"] > 0) == offloading
    assert out["wall"] > 0 and out["wait_critical"] >= 0


# -------------------------------------------------------------- heartbeat
def test_heartbeat_detects_failure(engine):
    tr = Transport(3, engine=engine)
    failures = []
    mon = HeartbeatMonitor(tr, engine, rank=0, watched=[1, 2],
                           timeout_s=0.15, sweep_interval_s=0.03,
                           on_failure=failures.append)
    stop = threading.Event()

    def rank1():     # healthy
        hb = HeartbeatSender(tr, 1, 0, interval_s=0.02)
        while not stop.is_set():
            hb.beat()
            time.sleep(0.01)

    def rank2():     # dies after 0.1s
        hb = HeartbeatSender(tr, 2, 0, interval_s=0.02)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.1:
            hb.beat()
            time.sleep(0.01)

    t1 = threading.Thread(target=rank1)
    t2 = threading.Thread(target=rank2)
    t1.start(); t2.start()
    deadline = time.monotonic() + 3.0
    while not failures and time.monotonic() < deadline:
        mon.progress()
        time.sleep(0.01)
    stop.set()
    t1.join(timeout=5.0); t2.join(timeout=5.0)
    assert not t1.is_alive() and not t2.is_alive()
    mon.stop()
    assert failures == [2], failures


def test_heartbeat_sweep_error_surfaces_in_progress(engine):
    """A raising on_failure callback must surface from monitor.progress(),
    not silently kill the sweep chain."""
    tr = Transport(2, engine=engine)

    def bad_on_failure(rank):
        raise RuntimeError("elastic controller exploded")

    mon = HeartbeatMonitor(tr, engine, rank=0, watched=[1],
                           timeout_s=0.01, sweep_interval_s=0.01,
                           on_failure=bad_on_failure)
    time.sleep(0.05)                   # rank 1 never beats -> stale
    with pytest.raises(RuntimeError, match="elastic controller"):
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            mon.progress()
            time.sleep(0.005)
    mon.stop()


def test_heartbeat_dead_on_arrival(engine):
    """A rank that never beats once is flagged one timeout after
    watch-start, and ``last_seen`` never holds a fabricated entry."""
    tr = Transport(2, engine=engine)
    failures = []
    mon = HeartbeatMonitor(tr, engine, rank=0, watched=[1],
                           timeout_s=0.05, sweep_interval_s=0.01,
                           on_failure=failures.append)
    deadline = time.monotonic() + 3.0
    while not failures and time.monotonic() < deadline:
        mon.progress()
        time.sleep(0.005)
    mon.stop()
    assert failures == [1]
    assert 1 not in mon.last_seen          # never fabricated a beat


def test_heartbeat_watch_unwatch(engine):
    """Elastic shrink: an unwatched rank's silence never fires
    on_failure; re-watching restarts its silence clock from now."""
    tr = Transport(3, engine=engine)
    failures = []
    mon = HeartbeatMonitor(tr, engine, rank=0, watched=[1, 2],
                           timeout_s=0.05, sweep_interval_s=0.01,
                           on_failure=failures.append)
    assert mon.watched == [1, 2]
    mon.unwatch(2)
    assert mon.watched == [1]
    hb = HeartbeatSender(tr, 1, 0, interval_s=0.005)
    deadline = time.monotonic() + 0.3
    while time.monotonic() < deadline:
        hb.beat()
        mon.progress()
        time.sleep(0.005)
    assert failures == []                  # 2 silent but unwatched
    mon.watch(2)
    deadline = time.monotonic() + 3.0
    while not failures and time.monotonic() < deadline:
        hb.beat()
        mon.progress()
        time.sleep(0.005)
    mon.stop()
    assert failures == [2]


def test_heartbeat_stall_guard(engine):
    """With ``stall_guard_s`` set, a long gap between sweeps restarts
    silence clocks instead of flagging ranks whose beats could not be
    observed."""
    tr = Transport(2, engine=engine)
    failures = []
    mon = HeartbeatMonitor(tr, engine, rank=0, watched=[1],
                           timeout_s=0.05, sweep_interval_s=0.01,
                           on_failure=failures.append,
                           stall_guard_s=0.05)
    hb = HeartbeatSender(tr, 1, 0, interval_s=0.005)
    hb.beat()
    mon.progress()
    time.sleep(0.2)                        # driver stalls >> timeout
    hb.beat()
    mon.progress()                         # stalled sweep: resets clocks
    assert failures == []
    deadline = time.monotonic() + 3.0
    while not failures and time.monotonic() < deadline:
        mon.progress()
        time.sleep(0.005)
    mon.stop()
    assert failures == [1]

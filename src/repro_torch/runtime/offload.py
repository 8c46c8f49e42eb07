"""Diffusive task offloading for straggler mitigation (paper §5.4).

The ExaHyPE scheme, rebuilt on this framework's transport: overloaded
(critical) ranks offload tasks to underloaded ranks. One offload is a
*group* of messages — task metadata + task input on the way out, and three
messages (result meta, result data, timing) on the way back — whose combined
completion triggers a single callback, exactly the request-group pattern the
paper replaces with ``MPIX_Continueall``.

Two interchangeable completion backends drive the comparison benchmarks
(and the Table-3 LoC analogue):

* ``ContinuationBackend`` — ``continue_all`` + ``enqueue_complete`` CR;
  completions fire as soon as any thread touches the engine/transport.
* ``TestsomeBackend`` — the reference application-space manager with a
  bounded ``MPI_Testsome`` window (completion of recently-posted requests is
  invisible until promoted into the window — the latency artifact the paper
  measures).

Emergencies (paper): a result that misses the iteration deadline halves the
quota toward that target and suspends it for a few timesteps; on-time
results grow quotas diffusively.

Task payloads and results are tensors on the manager's device. Each
manager queues its device work on a CUDA stream of its own, also from
callbacks that run on another rank's thread; a payload or result goes out
as a device tensor, matchable once the kernels that wrote it have run.
``run_offload`` drives the paper's imbalanced-ranks experiment.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import (ANY_SOURCE, Engine, Status, TestsomeManager,
                              Transport)
from repro_torch.core.transport import take
from repro_torch.util import resolve_device

TASK_META = 7001
TASK_DATA = 7002
RESULT_META = 7003
RESULT_DATA = 7004
RESULT_TIMING = 7005
LOAD_REPORT = 7006


# --------------------------------------------------------------- backends
class ContinuationBackend:
    """Group completion via MPIX_Continueall semantics (the paper's path)."""

    def __init__(self, engine: Engine) -> None:
        self.engine = engine
        self.cr = engine.continue_init(
            {"mpi_continue_enqueue_complete": True})

    def submit(self, ops: Sequence, cb: Callable, cb_data: Any = None) -> None:
        statuses = [None] * len(ops)
        self.engine.continue_all(ops, cb, cb_data, statuses=statuses,
                                 cr=self.cr)

    def progress(self) -> None:
        self.cr.test()

    def outstanding(self) -> int:
        return self.cr.active_count


class TestsomeBackend:
    """Reference: request groups via parallel arrays + Testsome window."""

    __test__ = False     # keep pytest from collecting this backend class

    def __init__(self, window: int = 16) -> None:
        self.manager = TestsomeManager(window=window)

    def submit(self, ops: Sequence, cb: Callable, cb_data: Any = None) -> None:
        self.manager.submit(list(ops), cb, cb_data, want_statuses=True)

    def progress(self) -> None:
        self.manager.testsome()

    def outstanding(self) -> int:
        return self.manager.outstanding


# ------------------------------------------------------------------ tasks
class Task:
    __slots__ = ("task_id", "cost_s", "payload", "done", "t_offloaded",
                 "result")

    def __init__(self, task_id: int, cost_s: float,
                 payload: Optional[torch.Tensor] = None,
                 device: Any = "cuda") -> None:
        self.task_id = task_id
        self.cost_s = cost_s
        self.payload = payload if payload is not None else \
            torch.full((64,), float(task_id), dtype=torch.float32,
                       device=resolve_device(device))
        self.done = threading.Event()
        self.t_offloaded = 0.0
        self.result: Any = None


def default_compute(cost_s: float, payload: torch.Tensor) -> torch.Tensor:
    """Burn ~cost_s of CPU (busy-ish wait keeps the GIL mostly released),
    then queue the result on the payload's device."""
    time.sleep(cost_s)
    return payload * 2.0 + 1.0


class OffloadManager:
    """Per-rank offloading endpoint + diffusive quota controller."""

    def __init__(self, rank: int, n_ranks: int, transport: Transport,
                 backend, *, compute: Callable = default_compute,
                 prepost: int = 4, quota_max: int = 64,
                 device: Any = "cuda") -> None:
        self.rank = rank
        self.n_ranks = n_ranks
        self.transport = transport
        self.backend = backend
        self.compute = compute
        self.device = resolve_device(device)
        # this rank's device work, whichever thread queues it
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.quota_max = quota_max
        self.quota: Dict[int, int] = {r: 1 for r in range(n_ranks)
                                      if r != rank}
        self.suspended: Dict[int, int] = {}
        self._task_seq = rank * 1_000_000
        self.inflight: Dict[int, Task] = {}
        self._lock = threading.Lock()
        self.stats = {"offloaded": 0, "executed_remote": 0, "emergencies": 0,
                      "returned": 0}
        self._stopped = False
        for _ in range(prepost):
            self._post_meta_recv()

    # ------------------------------------------------------- victim side
    def _post_meta_recv(self) -> None:
        op = self.transport.irecv(self.rank, source=ANY_SOURCE, tag=TASK_META)
        self.backend.submit([op], self._on_task_meta)

    def _on_task_meta(self, statuses, _):
        status: Status = statuses[0]
        if status.test_cancelled() or self._stopped:
            return
        task_id, source, cost_s = status.payload
        data_op = self.transport.irecv(self.rank, source=source,
                                       tag=TASK_DATA)
        self.backend.submit([data_op], self._on_task_data,
                            (task_id, source, cost_s))
        self._post_meta_recv()     # re-arm (paper: pre-posted receives)

    def _on_task_data(self, statuses, meta):
        task_id, source, cost_s = meta
        with torch.cuda.stream(self.stream):
            payload = take(statuses[0].payload)
            result = self.compute(cost_s, payload)
            self.stats["executed_remote"] += 1
            # result travels as three messages (paper §5.4 / Fig. 7)
            self.transport.isend(self.rank, source, RESULT_META,
                                 (task_id, self.rank))
            self.transport.isend(self.rank, source, RESULT_DATA,
                                 (task_id, result))
            self.transport.isend(self.rank, source, RESULT_TIMING,
                                 (task_id, time.monotonic()))

    # ------------------------------------------------------- source side
    def offload(self, task: Task, target: int) -> None:
        task.t_offloaded = time.monotonic()
        with self._lock:
            self.inflight[task.task_id] = task
        with torch.cuda.stream(self.stream):
            s_meta = self.transport.isend(
                self.rank, target, TASK_META,
                (task.task_id, self.rank, task.cost_s))
            s_data = self.transport.isend(self.rank, target, TASK_DATA,
                                          task.payload)
        # post the three result receives in the continuation of the sends —
        # keeps the active request count low (paper §5.4)
        self.backend.submit(
            [s_meta, s_data], self._on_sends_complete, (task.task_id, target))
        self.stats["offloaded"] += 1

    def _on_sends_complete(self, statuses, meta):
        task_id, target = meta
        recvs = [
            self.transport.irecv(self.rank, source=target, tag=RESULT_META),
            self.transport.irecv(self.rank, source=target, tag=RESULT_DATA),
            self.transport.irecv(self.rank, source=target, tag=RESULT_TIMING),
        ]
        self.backend.submit(recvs, self._on_result, task_id)

    def _on_result(self, statuses, task_id):
        _, result = statuses[1].payload
        take(result, self.stream)
        with self._lock:
            task = self.inflight.pop(task_id, None)
        if task is not None:
            task.result = result
            task.done.set()
            self.stats["returned"] += 1

    # ------------------------------------------------- diffusive control
    def pick_target(self, loads: Dict[int, float]) -> Optional[int]:
        """Least-loaded, non-suspended rank with remaining quota."""
        candidates = [(loads.get(r, 0.0), r) for r in self.quota
                      if self.suspended.get(r, 0) <= 0 and self.quota[r] > 0]
        if not candidates:
            return None
        return min(candidates)[1]

    def end_iteration(self, deadline_missed: Dict[int, bool]) -> None:
        """Diffusive quota update (paper's emergency mechanism)."""
        just_suspended = set()
        for target, missed in deadline_missed.items():
            if missed:
                self.stats["emergencies"] += 1
                self.quota[target] = max(1, self.quota[target] // 2)
                self.suspended[target] = 3
                just_suspended.add(target)
            else:
                # multiplicative-increase ramp (halved on emergencies above)
                self.quota[target] = min(self.quota_max,
                                         max(self.quota[target] + 1,
                                             self.quota[target] * 2))
        for r in list(self.suspended):
            if r not in just_suspended:
                self.suspended[r] = max(0, self.suspended[r] - 1)

    def new_task(self, cost_s: float) -> Task:
        self._task_seq += 1
        with torch.cuda.stream(self.stream):
            return Task(self._task_seq, cost_s, device=self.device)

    def stop(self) -> None:
        self._stopped = True


def run_offload(backend: str = "continuations", *, offloading: bool = True,
                iters: int = 8, task_cost_s: float = 0.003,
                device: Any = "cuda") -> Dict[str, Any]:
    """The paper's straggler experiment (§5.4, Fig. 8/9) on 4 rank
    threads: each iteration rank 0 has 6 times the tasks of the others
    (8 each); with ``offloading`` it offloads as many as its quotas allow
    to the least-loaded ranks, which run them from their progress calls
    while they wait at the iteration barrier. A task run where it was
    made costs the same sleep and computes the same ``payload * 2 + 1``.
    ``backend`` is ``"continuations"`` or ``"testsome"`` (a window of 8
    requests).

    Returns ``wall`` (seconds, host clock; the results are ordered after
    the ranks' work on the caller's current stream, so time a card run by
    a synchronise after the call), ``offloaded`` (by rank 0),
    ``wait_critical`` (rank 0's time waiting for offloaded results) and
    ``tasks`` (every task, with its ``result``)."""
    n_ranks, imbalance = 4, 6
    dev = resolve_device(device)
    engine = Engine()
    tr = Transport(n_ranks, engine=engine)
    make = (lambda: ContinuationBackend(engine)) \
        if backend == "continuations" else (lambda: TestsomeBackend(8))
    managers = [OffloadManager(r, n_ranks, tr, make(), device=dev)
                for r in range(n_ranks)]
    if dev.type == "cuda":
        for m in managers:
            m.stream.wait_stream(torch.cuda.current_stream(dev))
    arrived = [0] * iters
    lock = threading.Lock()
    wait_critical = [0.0]
    tasks_made: List[Task] = []
    errors: List[BaseException] = []

    def barrier(mgr, it):
        """Arrive at the barrier but keep serving while waiting."""
        with lock:
            arrived[it] += 1
        while True:
            with lock:
                if arrived[it] >= n_ranks:
                    return
            mgr.backend.progress()
            time.sleep(1e-4)

    def loop(rank):
        mgr = managers[rank]
        n_tasks = imbalance * 8 if rank == 0 else 8
        try:
            with torch.cuda.stream(mgr.stream):
                for it in range(iters):
                    tasks = [mgr.new_task(task_cost_s)
                             for _ in range(n_tasks)]
                    with lock:
                        tasks_made.extend(tasks)
                    pending = []
                    loads = {r: (imbalance if r == 0 else 1.0)
                             for r in range(n_ranks)}
                    budget = sum(mgr.quota.values()) if offloading else 0
                    for t in tasks:
                        target = mgr.pick_target(loads) if offloading \
                            else None
                        if rank == 0 and target is not None \
                                and len(pending) < budget:
                            mgr.offload(t, target)
                            pending.append(t)
                            loads[target] += 1.0
                        else:                      # execute locally
                            t.result = mgr.compute(t.cost_s, t.payload)
                            t.done.set()
                        mgr.backend.progress()
                    missed = {}
                    t_wait = time.monotonic()
                    deadline = t_wait + 5.0
                    for t in pending:
                        while not t.done.is_set() \
                                and time.monotonic() < deadline:
                            mgr.backend.progress()
                            time.sleep(5e-5)
                        if not t.done.is_set():
                            missed[1] = True
                    if rank == 0:
                        wait_critical[0] += time.monotonic() - t_wait
                    mgr.end_iteration(missed)
                    barrier(mgr, it)
        except BaseException as e:   # surfaced to the caller
            errors.append(e)
            with lock:               # release the others' barriers
                for i in range(iters):
                    arrived[i] = n_ranks
        finally:
            mgr.stop()

    threads = [threading.Thread(target=loop, args=(r,))
               for r in range(n_ranks)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    engine.shutdown()
    if errors:
        raise errors[0]
    if dev.type == "cuda":
        caller = torch.cuda.current_stream(dev)
        for m in managers:
            caller.wait_stream(m.stream)
        take([t.result for t in tasks_made], caller)
    return {"wall": wall, "offloaded": managers[0].stats["offloaded"],
            "wait_critical": wait_critical[0], "tasks": tasks_made}

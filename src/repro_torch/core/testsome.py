"""Reference *application-space* completion manager (the baseline).

This is the pattern the paper's evaluation sections describe and beat:

* **PaRSEC** (paper §5.3/Fig. 5): the communication thread keeps a
  deliberately small *active* request window passed to ``MPI_Testsome`` plus
  a *pending* list promoted into the window as slots free up — cheap testing,
  but recently-posted-yet-complete operations are not noticed until promoted.
* **ExaHyPE** (paper §5.4): an *offloading manager* maps request groups to
  callbacks "using multiple parallel data structures", progressed by passing
  a subset of active requests to ``MPI_Testsome``.

``TestsomeManager`` reproduces both artifacts faithfully so benchmarks can
measure the latency/throughput gap against the continuation engine, and so
the LoC/complexity comparison (paper Table 3) is grounded in real code in
this repo.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.completable import Completable
from repro_torch.core.status import Status

Callback = Callable[[Optional[List[Status]], Any], None]


class TestsomeManager:
    """Poll-based request manager with a bounded active window.

    The three parallel data structures below mirror the reference ExaHyPE
    offloading manager (request array / request→group map / group→callback
    map) that the paper replaces with a single ``MPIX_Continueall`` call.
    """

    __test__ = False     # name starts with "Test" but this is not a test class

    def __init__(self, window: int = 32) -> None:
        self.window = window
        self._lock = threading.Lock()
        self._group_seq = itertools.count()
        # -- parallel data structures (the complexity the paper removes) --
        self._active: List[Completable] = []          # testsome window
        self._pending: List[Completable] = []         # awaiting promotion
        self._op_group: Dict[int, int] = {}           # id(op) -> group id
        self._groups: Dict[int, dict] = {}            # group id -> record
        self.stats = {"submitted": 0, "test_calls": 0, "ops_tested": 0,
                      "callbacks": 0}

    # -------------------------------------------------------------- submit
    def submit(self, ops: Sequence[Completable], cb: Callback,
               cb_data: Any = None, want_statuses: bool = False,
               need: Optional[int] = None,
               indices_out: Optional[List[int]] = None) -> int:
        """Register a request group whose combined completion triggers ``cb``.

        ``need`` selects first-k-of-n semantics (the engine's
        ``continue_some`` analogue, kept feature-comparable here): the
        callback fires when ``need`` ops of the group completed; the
        group's losers are dropped from the window/pending lists (late
        completions are ignored). Default: all of them.

        ``indices_out``: caller list rewritten with the completed op
        indices (completion order, ``MPI_Waitsome`` style) before the
        callback fires — how first-k callers learn which ops won.
        """
        gid = next(self._group_seq)
        k = len(ops) if need is None else int(need)
        if not 1 <= k <= len(ops):
            raise ValueError(f"need 1 <= need <= {len(ops)}, got {k}")
        record = {
            "cb": cb, "cb_data": cb_data,
            "remaining": k,
            "ops": list(ops),
            "indices": [],          # completion order, Waitsome-style
            "indices_out": indices_out,
            "statuses": [Status() for _ in ops] if want_statuses else None,
            "index": {id(op): i for i, op in enumerate(ops)},
        }
        with self._lock:
            self._groups[gid] = record
            for op in ops:
                self._op_group[id(op)] = gid
                if len(self._active) < self.window:
                    self._active.append(op)
                else:
                    self._pending.append(op)
            self.stats["submitted"] += len(ops)
        return gid

    def submit_any(self, ops: Sequence[Completable], cb: Callback,
                   cb_data: Any = None, want_statuses: bool = False,
                   indices_out: Optional[List[int]] = None) -> int:
        """First-of-n (``MPI_Testany`` analogue in application space)."""
        return self.submit(ops, cb, cb_data, want_statuses, need=1,
                           indices_out=indices_out)

    def submit_some(self, ops: Sequence[Completable], k: int, cb: Callback,
                    cb_data: Any = None, want_statuses: bool = False,
                    indices_out: Optional[List[int]] = None) -> int:
        """First-k-of-n (``MPI_Testsome`` analogue in application space)."""
        return self.submit(ops, cb, cb_data, want_statuses, need=k,
                           indices_out=indices_out)

    # ------------------------------------------------------------- progress
    def testsome(self) -> int:
        """One progress pass: linear walk of the active window (the
        ``MPI_Testsome`` analogue), compact, promote pending, fire callbacks
        for fully-complete groups. Returns number of callbacks invoked.
        """
        fired: List[Tuple[Callback, Optional[List[Status]], Any]] = []
        with self._lock:
            self.stats["test_calls"] += 1
            self.stats["ops_tested"] += len(self._active)
            still_active: List[Completable] = []
            dropped: set = set()       # loser ops of first-k groups
            for op in self._active:
                if op.done():
                    gid = self._op_group.pop(id(op), None)
                    if gid is None:
                        continue
                    rec = self._groups[gid]
                    if rec["statuses"] is not None:
                        rec["statuses"][rec["index"][id(op)]] = op.status
                    rec["indices"].append(rec["index"][id(op)])
                    rec["remaining"] -= 1
                    if rec["remaining"] == 0:
                        if rec["indices_out"] is not None:
                            rec["indices_out"][:] = rec["indices"]
                        del self._groups[gid]
                        # first-k groups: drop the losers everywhere so
                        # their late completions are ignored
                        for other in rec["ops"]:
                            if self._op_group.pop(id(other), None) is not None:
                                dropped.add(id(other))
                        fired.append((rec["cb"], rec["statuses"], rec["cb_data"]))
                else:
                    still_active.append(op)
            self._active = [op for op in still_active
                            if id(op) not in dropped]
            if dropped:
                self._pending = [op for op in self._pending
                                 if id(op) not in dropped]
            # promote pending requests into freed window slots
            free = self.window - len(self._active)
            if free > 0 and self._pending:
                self._active.extend(self._pending[:free])
                del self._pending[:free]
        for cb, statuses, cb_data in fired:
            cb(statuses, cb_data)
        self.stats["callbacks"] += len(fired)
        return len(fired)

    def drain(self, *, max_iters: int = 10_000_000) -> None:
        """Progress until every submitted group has fired."""
        for _ in range(max_iters):
            with self._lock:
                if not self._groups:
                    return
            self.testsome()
        raise RuntimeError("TestsomeManager.drain did not converge")

    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self._groups)

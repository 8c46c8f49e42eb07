"""Multi-zone stencil solver — the NPB BT-MZ analogue (paper §5.2).

A 1-D ring of 2-D zones with up-to-20× uneven widths (BT-MZ's static
load-imbalance characteristic), Jacobi-smoothed each timestep with halo
columns exchanged between neighboring zones across ranks. Two execution
variants, mirroring the paper's comparison:

* ``fork_join``     — every timestep: compute ALL local zones, then
  exchange ALL boundaries and drain them with a Testsome-style waitall
  (the OpenMP work-sharing reference).
* ``continuations`` — per-zone dataflow: a zone's update task is released
  by the *continuation* of ``continue_all`` over its two halo receives
  (the detached-tasks + MPIX_Continueall variant, paper Listing 2). Zones
  with early neighbors compute immediately; no global barrier.

Zones are float64 tensors on ``device`` (the card unless the caller asks
for the CPU). Each rank queues its work on a CUDA stream of its own;
continuation callbacks may run on any thread, so every one of them queues
under ``torch.cuda.stream(rank.stream)``, never the thread's current
stream. Halo rows travel as device tensors, made matchable by the
transport once the kernels that wrote them have run. ``_smooth`` keeps
the reference's operation order, so every result is bit-identical to the
reference's numpy on the CPU and on the card (each fp64 add and multiply
is correctly rounded, and separate kernels contract no FMA).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import Engine, TestsomeManager, Transport
from repro_torch.core.transport import take
from repro_torch.util import resolve_device

HALO_TAG_BASE = 5000
WAIT_POLL_S = 5e-5     # a waiting rank's pause between two polls


def make_zones(n_zones: int, ny: int, base_nx: int, max_ratio: float = 20.0,
               seed: int = 0, device: Any = "cuda") -> List[torch.Tensor]:
    """Zone widths follow BT-MZ's uneven distribution (≈20× spread). The
    draws are the reference's (numpy, same seed), moved to ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    ratios = np.exp(np.linspace(0.0, np.log(max_ratio), n_zones))
    rng.shuffle(ratios)
    widths = np.maximum(4, (base_nx * ratios / ratios.mean()).astype(int))
    return [torch.from_numpy(np.asarray(rng.standard_normal((w, ny)),
                                        np.float64)).to(dev)
            for w in widths]


def _smooth(zone: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
            iters: int = 1) -> torch.Tensor:
    """Jacobi smoothing with halo columns; interior 5-point average."""
    for _ in range(iters):
        padded = torch.cat([left[None, :], zone, right[None, :]], dim=0)
        up = torch.roll(padded, 1, dims=1)
        down = torch.roll(padded, -1, dims=1)
        zone = 0.25 * (padded[:-2] + padded[2:] + up[1:-1] + down[1:-1])
    return zone


def reference_solve(zones: List[torch.Tensor], timesteps: int,
                    smooth_iters: int = 1) -> List[torch.Tensor]:
    """Single-rank oracle: synchronous ring exchange every step, on the
    calling thread's current stream."""
    zones = [z.clone() for z in zones]
    n = len(zones)
    for _ in range(timesteps):
        lefts = [zones[(i - 1) % n][-1, :].clone() for i in range(n)]
        rights = [zones[(i + 1) % n][0, :].clone() for i in range(n)]
        zones = [_smooth(zones[i], lefts[i], rights[i], smooth_iters)
                 for i in range(n)]
    return zones


class ZoneRank:
    """One rank of the distributed multi-zone solver."""

    def __init__(self, rank: int, n_ranks: int, all_sizes: List[int],
                 my_zones: Dict[int, torch.Tensor], transport: Transport,
                 engine: Optional[Engine], variant: str,
                 timesteps: int, smooth_iters: int = 1,
                 stream: Optional[torch.cuda.Stream] = None,
                 abort: Optional[threading.Event] = None) -> None:
        self.rank = rank
        self.n_ranks = n_ranks
        self.n_zones = len(all_sizes)
        self.zones = my_zones                     # zone_id -> tensor
        self.transport = transport
        self.engine = engine
        self.variant = variant
        self.timesteps = timesteps
        self.smooth_iters = smooth_iters
        self.stream = stream                      # None on the CPU
        # set when another rank failed; its waits then stop too
        self.abort = abort or threading.Event()
        self.owner = lambda z: z % n_ranks        # static round-robin
        self.wait_time = 0.0
        self.compute_time = 0.0                   # host time to queue it

    # ---------------------------------------------------------------- common
    def _neighbors(self, z: int) -> Tuple[int, int]:
        return (z - 1) % self.n_zones, (z + 1) % self.n_zones

    def _check_alive(self) -> None:
        """Between two polls of a wait: hand the interpreter to the ranks
        that queue work (a spinning rank holds it while they wait to
        launch their next kernel), and stop if another rank failed."""
        time.sleep(WAIT_POLL_S)
        if self.abort.is_set():
            raise RuntimeError(f"rank {self.rank}: another rank failed")

    def _tag(self, src_zone: int, dst_zone: int, step: int, side: int) -> int:
        return HALO_TAG_BASE + ((step % 2) * 2 + side) * self.n_zones ** 2 \
            + src_zone * self.n_zones + dst_zone

    def _send_boundaries(self, z: int, step: int) -> None:
        """Send zone ``z``'s edge rows (call under the rank's stream)."""
        left_n, right_n = self._neighbors(z)
        zone = self.zones[z]
        # side 0: my left edge → left neighbor's "right" halo; side 1 vice versa
        self.transport.isend(self.rank, self.owner(left_n),
                             self._tag(z, left_n, step, 0), zone[0, :].clone())
        self.transport.isend(self.rank, self.owner(right_n),
                             self._tag(z, right_n, step, 1),
                             zone[-1, :].clone())

    # -------------------------------------------------------------- fork-join
    def run_fork_join(self) -> None:
        mgr = TestsomeManager(window=16)
        for step in range(self.timesteps):
            for z in self.zones:
                self._send_boundaries(z, step)
            halos: Dict[int, List[Optional[torch.Tensor]]] = \
                {z: [None, None] for z in self.zones}
            done = {"n": 0}
            for z in self.zones:
                left_n, right_n = self._neighbors(z)
                r_left = self.transport.irecv(
                    self.rank, source=self.owner(left_n),
                    tag=self._tag(left_n, z, step, 1))
                r_right = self.transport.irecv(
                    self.rank, source=self.owner(right_n),
                    tag=self._tag(right_n, z, step, 0))

                def on_done(statuses, zz, h=halos, d=done):
                    h[zz][0] = statuses[0].payload
                    h[zz][1] = statuses[1].payload
                    d["n"] += 1

                mgr.submit([r_left, r_right], on_done, z, want_statuses=True)
            t0 = time.monotonic()
            while done["n"] < len(self.zones):     # waitall barrier
                mgr.testsome()
                self._check_alive()
            self.wait_time += time.monotonic() - t0
            t0 = time.monotonic()
            for z in self.zones:                    # then compute everything
                left, right = take(halos[z], self.stream)
                self.zones[z] = _smooth(self.zones[z], left, right,
                                        self.smooth_iters)
            self.compute_time += time.monotonic() - t0

    # ---------------------------------------------------------- continuations
    def run_continuations(self) -> None:
        """Zone tasks released by halo-completion continuations."""
        eng = self.engine
        cr = eng.continue_init({"mpi_continue_enqueue_complete": True})
        remaining = {"n": self.timesteps * len(self.zones)}
        # continuations may run on ANY rank's thread (paper §3) — the
        # counter decrement must be atomic across them
        rem_lock = threading.Lock()

        def post_zone(z: int, step: int) -> None:
            left_n, right_n = self._neighbors(z)
            r_left = self.transport.irecv(
                self.rank, source=self.owner(left_n),
                tag=self._tag(left_n, z, step, 1))
            r_right = self.transport.irecv(
                self.rank, source=self.owner(right_n),
                tag=self._tag(right_n, z, step, 0))
            statuses = [None, None]

            def on_halos(sts, zz):
                t0 = time.monotonic()
                # this thread's current stream may be another rank's
                with torch.cuda.stream(self.stream):
                    left, right = take((sts[0].payload, sts[1].payload))
                    self.zones[zz] = _smooth(self.zones[zz], left, right,
                                             self.smooth_iters)
                    self.compute_time += time.monotonic() - t0
                    with rem_lock:
                        remaining["n"] -= 1
                    if step + 1 < self.timesteps:
                        # send my new boundaries, then wait for the next halos
                        self._send_boundaries(zz, step + 1)
                        post_zone(zz, step + 1)

            eng.continue_all([r_left, r_right], on_halos, z,
                             statuses=statuses, cr=cr)

        for z in self.zones:
            self._send_boundaries(z, 0)
        for z in self.zones:
            post_zone(z, 0)
        t0 = time.monotonic()
        while remaining["n"] > 0:
            cr.test()
            self._check_alive()
        self.wait_time += max(0.0, time.monotonic() - t0 - self.compute_time)

    def run(self) -> None:
        with torch.cuda.stream(self.stream):
            if self.variant == "fork_join":
                self.run_fork_join()
            else:
                self.run_continuations()


def distributed_solve(zones: List[torch.Tensor], n_ranks: int, timesteps: int,
                      variant: str, smooth_iters: int = 1
                      ) -> Tuple[List[torch.Tensor], Dict[str, float]]:
    """Run the solver on ``n_ranks`` threads, on the zones' device; returns
    (zones, timings). The host never waits on the card: the returned zones
    are ordered after the ranks' work on the caller's current stream, and
    ``elapsed`` is host time, so time a card run by a synchronise after
    the call. A rank's error stops the others and is raised here."""
    engine = Engine()
    abort = threading.Event()
    transport = Transport(n_ranks, engine=engine)
    sizes = [z.shape[0] for z in zones]
    cuda = zones[0].is_cuda
    caller = torch.cuda.current_stream(zones[0].device) if cuda else None
    ranks = []
    for r in range(n_ranks):
        stream = torch.cuda.Stream(zones[0].device) if cuda else None
        if cuda:
            stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            mine = {i: take(zones[i]).clone() for i in range(len(zones))
                    if i % n_ranks == r}
        ranks.append(ZoneRank(r, n_ranks, sizes, mine, transport, engine,
                              variant, timesteps, smooth_iters, stream,
                              abort))
    errors: List[BaseException] = []

    def run(rk: ZoneRank) -> None:
        try:
            rk.run()
        except BaseException as e:   # surfaced to the caller
            errors.append(e)
            abort.set()

    threads = [threading.Thread(target=run, args=(rk,)) for rk in ranks]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t0
    if errors:
        engine.shutdown()
        raise errors[0]
    out: List[Optional[torch.Tensor]] = [None] * len(zones)
    for rk in ranks:
        if cuda:
            caller.wait_stream(rk.stream)
        for z, arr in rk.zones.items():
            out[z] = take(arr, caller)
    timings = {
        "elapsed": elapsed,
        "wait": sum(rk.wait_time for rk in ranks),
        "compute": sum(rk.compute_time for rk in ranks),
    }
    engine.shutdown()
    return out, timings

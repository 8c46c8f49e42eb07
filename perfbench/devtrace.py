"""A profiled slice of a traced run: ``torch.profiler`` over a few
seconds of the same load after the window has closed, its timeline written
under ``build/perfbench/`` and read back for the device's busy time, each
kernel's time and launches, and the idle gaps by what the host was doing
(the CUDA runtime calls recorded beside them: launches, graph replays,
copies, synchronisations).

The profiler's start-up takes seconds of the host, in which a serving
loop stalls and its slots empty, so it starts idle (``prepare``) and the
load settles before the slice (``start``) records; it stays out of the
window the other per-layer metrics read. Only CUDA activity is recorded:
recording every host op as well slows an eager prefill several times
over, and the slice would measure the profiler."""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench.spec import ROOT

OUT = ROOT / "build" / "perfbench"


class Slice:
    """``prepare()`` starts the profiler idle; ``start()`` and ``stop()``
    bound the recorded slice; ``read()`` after ``stop`` writes the
    timeline, parses it and deletes the file."""

    def __init__(self, name: str) -> None:
        self.path = OUT / f"{name}.trace.json"
        self._prof: Optional[torch.profiler.profile] = None
        self.wall_s = 0.0
        self.start_s = 0.0          # host seconds ``prepare`` took
        self._t0 = 0.0

    def prepare(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CUDA] \
            if torch.cuda.is_available() else \
            [torch.profiler.ProfilerActivity.CPU]
        t = time.monotonic()
        self._prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1))
        self._prof.__enter__()
        self.start_s = time.monotonic() - t

    def start(self) -> None:
        self._prof.step()           # idle -> recording
        self._t0 = time.monotonic()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.monotonic() - self._t0
        self._prof.__exit__(None, None, None)

    def read(self) -> "Timeline":
        OUT.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        events = json.loads(self.path.read_text())["traceEvents"]
        self.path.unlink()          # a run leaves no timeline behind
        tl = Timeline(events, self.wall_s)
        tl.start_s = self.start_s
        return tl


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Timeline:
    """Device operations (kernels, copies, memsets) and host calls of one
    slice, in seconds."""

    DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")

    def __init__(self, events: List[Dict[str, Any]], wall_s: float) -> None:
        self.kernels = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6)
                        for e in events
                        if e.get("ph") == "X" and e.get("cat") in self.DEVICE]
        self.host = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6)
                     for e in events
                     if e.get("ph") == "X" and e.get("cat") in
                     ("cpu_op", "cuda_runtime", "user_annotation")]
        self.wall_s = wall_s
        busy = _union([(t, t + d) for _, t, d in self.kernels])
        self.busy_s = sum(e - s for s, e in busy)
        self._busy = busy

    @property
    def window_s(self) -> float:
        """The slice's length: the host's clock between its start and
        stop, or the span of the device operations it recorded where
        that is longer (a step in flight at either edge)."""
        if not self._busy:
            return self.wall_s
        return max(self.wall_s, self._busy[-1][1] - self._busy[0][0])

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """Kernel name -> (launches, seconds)."""
        out: Dict[str, Tuple[int, float]] = {}
        for name, _, d in self.kernels:
            n, s = out.get(name, (0, 0.0))
            out[name] = (n + 1, s + d)
        return out

    def top_ops(self, k: int = 10) -> List[List[Any]]:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])
        return [[name, secs] for name, (_, secs) in ops[:k]]

    def idle_gaps(self, k: int = 10) -> List[List[Any]]:
        """The ``k`` longest gaps between device operations, each named
        by the host op that overlaps it most (the innermost of equals)."""
        gaps = [(self._busy[i][1], self._busy[i + 1][0])
                for i in range(len(self._busy) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        out = []
        for s, e in gaps:
            best, name = (0.0, 0.0), "no host op"
            for n, t, d in self.host:
                ov = min(e, t + d) - max(s, t)
                if ov > 0 and (ov, -d) > best:
                    best, name = (ov, -d), n
            out.append([name, e - s])
        return out

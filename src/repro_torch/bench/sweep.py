"""Saturation sweep — the max sustainable QPS where an SLO still holds.

A throughput number without a latency bound is marketing; the defensible
form of "how fast is this config" is *the highest offered load at which
the SLO is still met*. ``saturation_sweep`` binary-searches that
boundary over any monotone-ish evaluate function; ``sweep_tier`` builds
the evaluate from the real pipeline — rescale one seeded trace to the
probe QPS (same prompts, same ordering: only the arrival clock changes),
replay it on a warm ``Replayer``, and ask ``bench.report`` whether the
SLO held.

The search contract:

* SLO fails at ``lo_qps``  → ``max_qps`` is ``None`` (the config cannot
  meet the SLO at any probed load; the lo point is in ``points``).
* SLO holds at ``hi_qps`` → ``max_qps == hi_qps`` (saturation is beyond
  the probed range — widen it).
* otherwise ``iters`` bisection steps between the known-good and
  known-bad loads; ``max_qps`` is the highest passing probe.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.bench.report import SLO, slo_report
from repro_torch.bench.runner import Replayer
from repro_torch.bench.trace import Trace, rescale_qps

# evaluate(qps) -> (slo_ok, info-dict)
Evaluate = Callable[[float], Tuple[bool, Dict[str, Any]]]


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    qps: float
    ok: bool
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    max_qps: Optional[float]          # None: SLO unmet even at lo_qps
    lo_qps: float
    hi_qps: float
    points: Tuple[SweepPoint, ...]
    saturated_range: bool = False     # True: SLO held all the way to hi

    def to_dict(self) -> Dict[str, Any]:
        points = []
        for p in self.points:
            d: Dict[str, Any] = {"qps": round(p.qps, 4), "ok": p.ok}
            # keep enough of the probe report to see WHY it failed
            # (worst value per violated bound) without embedding the
            # full per-sample report in every artifact
            for v in p.info.get("slo", {}).get("violations", []):
                d.setdefault("violations", []).append(
                    {k: v[k] for k in ("metric", "bound", "worst")
                     if k in v})
            points.append(d)
        return {"max_sustainable_qps": self.max_qps,
                "lo_qps": self.lo_qps, "hi_qps": self.hi_qps,
                "saturated_range": self.saturated_range,
                "points": points}


def saturation_sweep(evaluate: Evaluate, *, lo_qps: float, hi_qps: float,
                     iters: int = 4) -> SweepResult:
    """Binary-search the pass/fail boundary of ``evaluate`` over
    ``[lo_qps, hi_qps]`` (see module docstring for the edge contract)."""
    if not (0 < lo_qps < hi_qps):
        raise ValueError(f"need 0 < lo_qps < hi_qps, got "
                         f"lo={lo_qps} hi={hi_qps}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    points: List[SweepPoint] = []

    def probe(qps: float) -> bool:
        ok, info = evaluate(qps)
        points.append(SweepPoint(qps=qps, ok=bool(ok), info=info))
        return bool(ok)

    if not probe(lo_qps):
        return SweepResult(max_qps=None, lo_qps=lo_qps, hi_qps=hi_qps,
                           points=tuple(points))
    if probe(hi_qps):
        return SweepResult(max_qps=hi_qps, lo_qps=lo_qps, hi_qps=hi_qps,
                           points=tuple(points), saturated_range=True)
    good, bad = lo_qps, hi_qps
    for _ in range(iters):
        mid = (good + bad) / 2.0
        if probe(mid):
            good = mid
        else:
            bad = mid
    return SweepResult(max_qps=good, lo_qps=lo_qps, hi_qps=hi_qps,
                       points=tuple(points))


def sweep_tier(replayer: Replayer, trace: Trace, slo: SLO, *,
               lo_qps: float, hi_qps: float, iters: int = 4,
               samples: int = 1, retries: int = 1,
               timeout: float = 300.0) -> SweepResult:
    """Find the max sustainable QPS of ``replayer``'s tier on ``trace``
    under ``slo``. The trace must be open-loop (rescaling a closed-loop
    trace is meaningless); each probe replays the SAME requests at the
    probe rate, so the boundary is a property of load, not workload.

    ``retries``: a FAILED probe is re-run up to this many times and
    passes if any attempt meets the SLO. A false "pass" costs one wasted
    bisection step; a false "fail" (one ambient-load straggler blowing a
    tail bound) is sticky — it permanently caps the reported boundary —
    so failures must be confirmed, not taken on first sight."""

    def evaluate(qps: float) -> Tuple[bool, Dict[str, Any]]:
        probe_trace = rescale_qps(trace, qps)
        report: Dict[str, Any] = {}
        for _attempt in range(1 + max(0, retries)):
            results = replayer.run(probe_trace, samples=samples,
                                   timeout=timeout)
            report = slo_report(results, slo)
            if report["slo"]["ok"]:
                break
        return report["slo"]["ok"], report

    return saturation_sweep(evaluate, lo_qps=lo_qps, hi_qps=hi_qps,
                            iters=iters)

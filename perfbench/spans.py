"""Reading the program's tracer spans, for the per-layer metrics that
take a percentile of one kind of span."""
from __future__ import annotations

from typing import Any, List

from perfbench.traffic.stats import percentile


def span_p95(run: Any, kind: str, scale: float):
    """95th percentile of the ``kind`` spans that start in the window,
    times ``scale``; None where the run traced none."""
    durs: List[float] = [e.dur * scale for e in run.events
                         if e.kind == kind and run.in_window(e.ts)]
    return percentile(durs, 0.95) if durs else None

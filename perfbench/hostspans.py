"""The program's host spans set against a profiled slice's device timeline,
and the trainer's spans over a window.

The tracer stamps on ``time.monotonic``; ``torch.profiler``'s timeline is
in seconds after its document's ``baseTimeNanoseconds``, on the Unix
clock. ``Tracer.to_unix`` bridges the two, so a span ``[ts, ts + dur]``
lies at ``[to_unix(ts) - base_s, ...]`` on the timeline. The readers here
intersect such intervals with the slice's device-idle gaps (between the
union of its device operations that ``devtrace.Timeline`` keeps) and with
the runtime calls the profiler recorded beside them.

A timeline given to these readers carries ``base_s`` (its document's base
in seconds); the accepted ``devtrace.Timeline`` does not keep it, and
``perfbench/span_run.py`` adds it (see there).
"""
from __future__ import annotations

import bisect
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

from perfbench.devtrace import _union

Interval = Tuple[float, float]

#: the host spans that account for the serve loop's time: a prefill's
#: enqueue, a step's dispatch, a poll that found work, a continuation's
#: callback
LOOP_KINDS = ("engine.prefill", "engine.dispatch", "progress.scan",
              "cont.ran")
#: a runtime call lies within a span up to this slack on either side
CLOCK_SLACK_S = 1e-4


def on_timeline(events: Iterable[Any], kinds: Sequence[str],
                to_unix: Callable[[float], float], base_s: float
                ) -> List[Interval]:
    """The union of the ``kinds`` spans, in the timeline's seconds."""
    spans = []
    for e in events:
        if e.kind in kinds:
            s = to_unix(e.ts) - base_s
            spans.append((s, s + e.dur))
    return _union(spans)


def idle_gaps(timeline: Any) -> List[Interval]:
    """The gaps between the device's operations (first to last), from the
    timeline's own union of them."""
    busy = timeline._busy
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:])]


def overlap_s(a: List[Interval], b: List[Interval]) -> float:
    """Seconds that two sorted lists of disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(timeline: Any, events: Iterable[Any], kinds: Sequence[str],
               to_unix: Callable[[float], float]) -> Optional[float]:
    """Percent of the device's idle time that ``kinds`` spans cover; None
    where the device was never idle or no span was recorded at all."""
    events = list(events)
    gaps = idle_gaps(timeline)
    idle = sum(e - s for s, e in gaps)
    if idle <= 0 or not events:
        return None
    spans = on_timeline(events, kinds, to_unix, timeline.base_s)
    return 100.0 * overlap_s(gaps, spans) / idle


def idle_in_prefill_share(timeline: Any, events: Iterable[Any],
                          to_unix: Callable[[float], float]
                          ) -> Optional[float]:
    """``idle_in_prefill_share.decode``: the device's idle time in which
    the loop was enqueueing a prefill (``engine.prefill``)."""
    return idle_share(timeline, events, ("engine.prefill",), to_unix)


def idle_unspanned_share(timeline: Any, events: Iterable[Any],
                         to_unix: Callable[[float], float]
                         ) -> Optional[float]:
    """``idle_unspanned_share.decode``: the device's idle time that no
    span of the loop's own work (``LOOP_KINDS``) covers."""
    covered = idle_share(timeline, events, LOOP_KINDS, to_unix)
    return None if covered is None else 100.0 - covered


def calls_within_share(timeline: Any, name: str, events: Iterable[Any],
                       kind: str, to_unix: Callable[[float], float],
                       slack: float = CLOCK_SLACK_S
                       ) -> Tuple[Optional[float], int]:
    """Percent of the profiler's ``name`` runtime calls that lie inside a
    ``kind`` span (widened by ``slack``), and how many calls there were:
    the check that the two clocks agree."""
    spans = _union([(s - slack, e + slack) for s, e in
                    on_timeline(events, (kind,), to_unix, timeline.base_s)])
    starts = [s for s, _ in spans]
    calls = [(t, t + d) for n, t, d in timeline.host if n == name]
    if not calls:
        return None, 0
    inside = 0
    for s, e in calls:
        k = bisect.bisect_right(starts, s) - 1     # the last span by s
        if k >= 0 and spans[k][1] >= e:
            inside += 1
    return 100.0 * inside / len(calls), len(calls)


def device_s_in_spans(timeline: Any, events: Iterable[Any], kind: str,
                      to_unix: Callable[[float], float]
                      ) -> Dict[int, float]:
    """Device seconds of the operations launched inside each ``kind`` span
    that the slice recorded whole, by the span's ``rid``: an operation
    counts for the span its runtime call starts in (the profiler's
    ``correlation`` links the two). Its busy time, not its span on the
    stream. The timeline carries ``launches`` (each runtime call's start
    and correlation) and ``device_s`` (correlation -> device seconds)."""
    if not timeline.launches:
        return {}
    lo = min(t for t, _ in timeline.launches)
    hi = max(t for t, _ in timeline.launches)
    spans = sorted((to_unix(e.ts) - timeline.base_s, e.dur, e.rid)
                   for e in events if e.kind == kind)
    spans = [(s, s + d, rid) for s, d, rid in spans if lo <= s and s + d <= hi]
    starts = [s for s, _, _ in spans]
    out = {rid: 0.0 for _, _, rid in spans}
    for t, corr in timeline.launches:
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= spans[k][1]:
            out[spans[k][2]] += timeline.device_s.get(corr, 0.0)
    return out


def _train_spans(run: Any, kind: str) -> List[float]:
    return [e.dur for e in run.events
            if e.kind == kind and run.t_open <= e.ts < run.t_close]


def batch_wait_ms(run: Any) -> Optional[float]:
    """``batch_wait_ms.train``: milliseconds the loop waited in
    ``PrefetchPipeline.get_next`` (``data.wait``) in the window, per
    iteration in it."""
    if not run.host_s:
        return None
    return 1e3 * sum(_train_spans(run, "data.wait")) / len(run.host_s)


def step_dispatch_ms(run: Any) -> Optional[float]:
    """``step_dispatch_ms.train``: the mean ``train.dispatch`` span (host
    milliseconds to enqueue a step) in the window."""
    durs = _train_spans(run, "train.dispatch")
    return 1e3 * sum(durs) / len(durs) if durs else None

"""Exporters: Chrome/Perfetto ``trace_event`` JSON + Prometheus text.

``chrome_trace`` renders drained events as the Trace Event Format both
``chrome://tracing`` and https://ui.perfetto.dev load directly: one
"process" per correlated request (shadow requests collapse onto their
original via ``req.link``), with a named "thread" row per emitting
component, so a request's admission -> prefill -> ship/import -> steps
-> delivery reads left-to-right on one track. Runtime-internal events
(``cont.*``, ``progress.*``) land in a shared pid 0 process keyed by
real thread id.

``prometheus_text`` renders a point-in-time text-exposition snapshot:
serve/transport counters as gauges plus the lifecycle histograms in
cumulative-bucket form.
"""
from __future__ import annotations

import re
from numbers import Number
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.obs.events import Event, link_roots
from repro_torch.obs.hist import BOUNDS, Histogram

#: stable row order for the per-request component threads.
_SRC_ROWS = ("client", "router", "engine", "prefill", "decode", "serve",
             "core", "bench")


def _track(src: str) -> int:
    try:
        return _SRC_ROWS.index(src) + 1
    except ValueError:
        return len(_SRC_ROWS) + 1


def chrome_trace(events: Iterable[Event], *,
                 histograms: Optional[Mapping[Tuple[str, str],
                                              Histogram]] = None,
                 dropped: int = 0) -> dict:
    """Events -> a ``{"traceEvents": [...]}`` document (JSON-serializable)."""
    events = list(events)
    roots = link_roots(events)
    t0 = min((ev.ts for ev in events), default=0.0)
    out: List[dict] = []
    seen_pids: Dict[int, str] = {}
    seen_tids: set = set()

    def _meta(pid: int, name: str) -> None:
        if pid not in seen_pids:
            seen_pids[pid] = name
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": name}})

    def _tmeta(pid: int, tid: int, name: str) -> None:
        if (pid, tid) not in seen_tids:
            seen_tids.add((pid, tid))
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": name}})

    for ev in events:
        if ev.kind.startswith("req.") and ev.rid >= 0:
            rid = roots.get(ev.rid, ev.rid)
            pid = rid + 1                       # pid 0 is the runtime
            _meta(pid, f"request {rid}")
            tid = _track(ev.src)
            _tmeta(pid, tid, ev.src or "serve")
        else:
            pid = 0
            _meta(pid, "runtime")
            tid = ev.tid
            _tmeta(pid, tid, f"thread {tid}")
        rec = {"name": ev.kind, "cat": ev.kind.split(".")[0],
               "pid": pid, "tid": tid,
               "ts": round((ev.ts - t0) * 1e6, 3),
               "args": {"rid": ev.rid, "meta": _jsonable(ev.meta)}}
        if ev.dur > 0.0:
            rec["ph"] = "X"
            rec["dur"] = round(ev.dur * 1e6, 3)
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        out.append(rec)

    doc = {"traceEvents": out, "displayTimeUnit": "ms",
           "otherData": {"dropped_events": dropped,
                         "event_count": len(events)}}
    if histograms:
        doc["otherData"]["lifecycle_histograms"] = {
            f"{edge}|{pkey}": h.to_dict()
            for (edge, pkey), h in sorted(histograms.items())}
    return doc


def _jsonable(meta):
    if meta is None or isinstance(meta, (int, float, str, bool)):
        return meta
    if isinstance(meta, (list, tuple)):
        return [_jsonable(m) for m in meta]
    if isinstance(meta, dict):
        return {str(k): _jsonable(v) for k, v in meta.items()}
    return repr(meta)


# ------------------------------------------------------------- prometheus
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _san(name: str) -> str:
    return _NAME_RE.sub("_", str(name))


def prometheus_text(metrics: Optional[Mapping] = None, *,
                    histograms: Optional[Mapping[Tuple[str, str],
                                                 Histogram]] = None,
                    dropped: int = 0,
                    transport: Optional[Mapping] = None,
                    prefix: str = "repro") -> str:
    """Text-exposition snapshot unifying serve metrics, transport
    counters, and the lifecycle histograms.

    ``metrics`` is any scalar mapping (a ``ServeMetrics`` works as-is);
    ``transport`` takes a ``Transport.stats()`` dict and expands the
    ``per_tag`` map into labelled counters.
    """
    lines: List[str] = []

    def gauge(name: str, value, labels: str = "") -> None:
        if isinstance(value, bool) or not isinstance(value, Number):
            return
        lines.append(f"{prefix}_{name}{labels} {float(value):g}")

    lines.append(f"# TYPE {prefix}_trace_dropped_events counter")
    gauge("trace_dropped_events", dropped)

    if metrics:
        lines.append(f"# TYPE {prefix}_serve gauge")
        for key, value in metrics.items():
            gauge(f"serve_{_san(key)}", value)

    if transport:
        lines.append(f"# TYPE {prefix}_transport counter")
        for key, value in transport.items():
            if key == "per_tag":
                for tag, counters in value.items():
                    for cname, cval in counters.items():
                        gauge(f"transport_{_san(cname)}", cval,
                              f'{{tag="{tag}"}}')
            else:
                gauge(f"transport_{_san(key)}", value)

    if histograms:
        hname = f"{prefix}_lifecycle_latency_us"
        lines.append(f"# TYPE {hname} histogram")
        for (edge, pkey), h in sorted(histograms.items()):
            base = f'edge="{_san(edge)}",policy="{pkey}"'
            cum = 0
            for i, count in enumerate(h.counts):
                cum += count
                le = f"{BOUNDS[i]:g}" if i < len(BOUNDS) else "+Inf"
                lines.append(f'{hname}_bucket{{{base},le="{le}"}} {cum}')
            lines.append(f"{hname}_sum{{{base}}} {h.total:g}")
            lines.append(f"{hname}_count{{{base}}} {h.count}")
    return "\n".join(lines) + "\n"

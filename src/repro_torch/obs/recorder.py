"""Recorder — a detachable tracing session handle for harness code.

The bench ``Replayer`` (and anything else that wants "trace exactly this
window") attaches a ``Recorder``: entering starts a fresh global tracing
session, exiting drains it into the recorder's accumulated events and
histograms. Multiple start/stop cycles accumulate, so a replayer can
trace only its *measured* samples while warmup stays untraced.

Besides raw export (``chrome_trace`` / ``write`` / ``prometheus``), the
recorder aggregates per-request *cause* attribution for SLO reports:
how much of the observed latency was scheduler queue delay vs compute
(prefill + decode-step spans) vs KV shipping across the disagg
transport.

Counterpart of ``repro/obs/recorder.py``. The engine stamps a
``req.step`` span from a step's dispatch to the continuation that
delivers its tokens, and a ``req.prefill`` span from the prefill's
dispatch to its continuation. On a CUDA device those continuations run
once the step's ``TensorOp`` is polled complete, so "compute" includes
the card's time for the step (and any wait behind earlier work queued on
the stream), as it includes the TPU's in the reference.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.obs import export, tracer
from repro_torch.obs.events import (EDGE_COMPLETE_TO_RUN, REQ_ADMIT, REQ_KV_IMPORT,
                              REQ_KV_SHIP, REQ_PREFILL, REQ_STEP, Event)
from repro_torch.obs.hist import Histogram


class Recorder:
    """Accumulating trace session: start/stop (or ``with``) around the
    window of interest, then export or summarize."""

    def __init__(self, *, sample: float = 1.0,
                 capacity: int = tracer.DEFAULT_CAPACITY) -> None:
        self.sample = sample
        self.capacity = capacity
        self.events: List[Event] = []
        self.histograms: Dict[Tuple[str, str], Histogram] = {}
        self.dropped = 0
        self._active = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Recorder":
        if self._active:
            return self
        tracer.start(sample=self.sample, capacity=self.capacity)
        self._active = True
        return self

    def stop(self) -> "Recorder":
        if not self._active:
            return self
        self._active = False
        tr = tracer.stop()
        if tr is not None:
            self.dropped += tr.dropped
            self.events.extend(tr.drain())
            for key, h in tr.histograms().items():
                mine = self.histograms.setdefault(key, Histogram())
                mine.merge(h)
        return self

    def __enter__(self) -> "Recorder":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -------------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        return export.chrome_trace(self.events, histograms=self.histograms,
                                   dropped=self.dropped)

    def write(self, path: str) -> str:
        """Write the Chrome/Perfetto trace JSON; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def prometheus(self, metrics: Optional[Mapping] = None,
                   transport: Optional[Mapping] = None) -> str:
        return export.prometheus_text(metrics, histograms=self.histograms,
                                      dropped=self.dropped,
                                      transport=transport)

    # ------------------------------------------------------------- analysis
    def by_kind(self) -> Counter:
        return Counter(ev.kind for ev in self.events)

    def cause_summary(self) -> dict:
        """Where request time went: queue delay vs compute vs shipping.

        Returns mean milliseconds per request for each cause, plus the
        notification-latency mean so SLO reports can cite the runtime's
        own contribution.
        """
        admit: Dict[int, float] = {}
        compute: Dict[int, float] = {}
        ship_t: Dict[Tuple[int, object], float] = {}
        ship_gap: Dict[int, float] = {}
        for ev in self.events:
            if ev.kind == REQ_ADMIT:
                admit[ev.rid] = admit.get(ev.rid, 0.0) + ev.dur
            elif ev.kind in (REQ_STEP, REQ_PREFILL):
                compute[ev.rid] = compute.get(ev.rid, 0.0) + ev.dur
            elif ev.kind == REQ_KV_SHIP:
                ship_t[(ev.rid, _block(ev.meta))] = ev.ts
            elif ev.kind == REQ_KV_IMPORT:
                t_ship = ship_t.get((ev.rid, _block(ev.meta)))
                if t_ship is not None:
                    ship_gap[ev.rid] = (ship_gap.get(ev.rid, 0.0)
                                        + max(0.0, ev.ts - t_ship))

        def mean_ms(d: Dict) -> float:
            return (sum(d.values()) / len(d) * 1e3) if d else 0.0

        notify_us = 0.0
        n = 0
        for (edge, _), h in self.histograms.items():
            if edge == EDGE_COMPLETE_TO_RUN:
                notify_us += h.total
                n += h.count
        return {"requests": len(set(admit) | set(compute)),
                "queue_delay_ms_mean": round(mean_ms(admit), 3),
                "compute_ms_mean": round(mean_ms(compute), 3),
                "shipping_ms_mean": round(mean_ms(ship_gap), 3),
                "notify_latency_us_mean": round(notify_us / n, 3) if n else 0.0,
                "events": len(self.events), "dropped": self.dropped}


def _block(meta):
    if isinstance(meta, (list, tuple)) and meta:
        return meta[0]
    return meta

"""Continuation-runtime observability: tracing and lifecycle histograms.

A copy of the reference package's tracer (``obs.tracer``, ``obs.buffer``,
``obs.hist``) and event taxonomy (``obs.events``); the port's ``core`` and
``serve`` emit into it. The Perfetto/Prometheus exporters and the bench
``Recorder`` are not ported yet.

Usage::

    from repro_torch import obs

    obs.start(sample=1.0)          # or REPRO_TRACE=1 in the environment
    ... run traced work ...
    tr = obs.stop()
    events = tr.drain()
"""
from repro_torch.obs.buffer import TraceBuffer
from repro_torch.obs.events import (CONT_ENQUEUED, CONT_POSTED, CONT_RAN,
                                    CONT_READY, LIFECYCLE_EDGES, Event,
                                    link_roots, policy_key)
from repro_torch.obs.hist import Histogram
from repro_torch.obs.tracer import Tracer, active, is_enabled, start, stop

__all__ = [
    "TraceBuffer", "Event", "Histogram", "Tracer",
    "CONT_POSTED", "CONT_READY", "CONT_ENQUEUED", "CONT_RAN",
    "LIFECYCLE_EDGES", "link_roots", "policy_key",
    "active", "is_enabled", "start", "stop",
]

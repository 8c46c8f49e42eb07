"""Continuation-runtime observability: tracing, timelines, metrics export.

A copy of the reference package's ``obs``: the default-off tracer
(``obs.tracer``, ``obs.buffer``, ``obs.hist``) and event taxonomy
(``obs.events``) that the port's ``core`` and ``serve`` emit into, the
Chrome/Perfetto ``trace_event`` and Prometheus text exporters
(``obs.export``), and the ``Recorder`` that the bench ``Replayer``
attaches to trace its measured samples and split their latency by cause
(``obs.recorder``).

Beside the reference's kinds, the port's serve loop and trainer record
host spans of their own work (``engine.prefill``, ``engine.dispatch``,
``data.wait``, ``train.dispatch``) and, on a card, ``dev.step`` and
``dev.prefill``, whose durations are **device** seconds between CUDA
timing events on the stream, the stream's waits for the host included
(their ``ts`` is the host's dispatch stamp). The
tracer's clock is ``time.monotonic``; ``Tracer.to_unix`` maps a stamp onto
the Unix clock of ``torch.profiler``'s timeline (``baseTimeNanoseconds``
plus ``ts``), so host spans can be set against the device's activity.

Usage::

    from repro_torch import obs

    obs.start(sample=1.0)          # or REPRO_TRACE=1 in the environment
    ... run traced work ...
    tr = obs.stop()
    doc = obs.chrome_trace(tr.drain(), histograms=tr.histograms(),
                           dropped=tr.dropped)
"""
from repro_torch.obs.buffer import TraceBuffer
from repro_torch.obs.events import (CONT_ENQUEUED, CONT_POSTED, CONT_RAN,
                                    CONT_READY, LIFECYCLE_EDGES, Event,
                                    link_roots, policy_key)
from repro_torch.obs.export import chrome_trace, prometheus_text
from repro_torch.obs.hist import Histogram
from repro_torch.obs.recorder import Recorder
from repro_torch.obs.tracer import Tracer, active, is_enabled, start, stop

__all__ = [
    "TraceBuffer", "Event", "Histogram", "Tracer", "Recorder",
    "CONT_POSTED", "CONT_READY", "CONT_ENQUEUED", "CONT_RAN",
    "LIFECYCLE_EDGES", "link_roots", "policy_key",
    "chrome_trace", "prometheus_text",
    "active", "is_enabled", "start", "stop",
]

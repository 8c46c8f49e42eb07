"""Run one cell as ``run.py`` does, with the program's tracer also armed
where the harness does not arm it, and print the span readings of
``hostspans`` as one more line after the result line.

    python3 perfbench/span_run.py --workload <cell> --seed <n> \
        --seconds <s> --trace 1

From the root of a checkout, on a card. The result line is ``run.py``'s,
and the run is its run: this script only wraps, in its own process,
``devtrace.Slice`` (a tracer session from the profiled slice's start to
its stop; the timeline keeps its document's ``baseTimeNanoseconds``) and
a train cell's ``run`` (a tracer session over the whole run, read over the
window). The last line is ``{"spans": {...}}``: in a serve cell
``idle_in_prefill_share.decode``, ``idle_unspanned_share.decode``, the
share of the idle time in each of ``hostspans.LOOP_KINDS`` alone
(``idle_in.<kind>``), the clock check (``graph_launch_in_dispatch_share``:
the profiler's ``cudaGraphLaunch`` calls inside an ``engine.dispatch``
span, and their count), ``unix_drift_us`` (the slice session's
``to_unix`` offset at stop less at start) and, for the prefills the slice
holds whole, the device's busy time launched inside each
``engine.prefill`` span against its ``dev.prefill`` span on the stream
(``prefill_busy_ms_p95``, ``prefill_stream_ms_p95``,
``prefill_busy_share_of_stream``); in a train cell
``batch_wait_ms.train`` and ``step_dispatch_ms.train``. A reading with
nothing to read is left out.
"""
from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from typing import Any, Dict, Iterator

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import devtrace, hostspans  # noqa: E402
from perfbench.traffic.stats import percentile  # noqa: E402

#: ring capacity a thread of a slice's session, as the serve window's
SLICE_CAPACITY = 1 << 21


class SpannedSlice(devtrace.Slice):
    """A profiled slice with a tracer session over it."""

    def start(self) -> None:
        from repro_torch.obs import tracer as obs
        self.tracer = obs.start(capacity=SLICE_CAPACITY)
        super().start()

    def stop(self) -> None:
        from repro_torch.obs import tracer as obs
        super().stop()
        obs.stop()

    def read(self) -> devtrace.Timeline:
        # ``Slice.read`` with the document's base kept
        devtrace.OUT.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        doc = json.loads(self.path.read_text())
        self.path.unlink()
        tl = devtrace.Timeline(doc["traceEvents"], self.wall_s)
        tl.start_s = self.start_s
        tl.base_s = doc["baseTimeNanoseconds"] * 1e-9
        tl.launches, tl.device_s = [], {}
        for e in doc["traceEvents"]:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("ph") != "X" or corr is None:
                continue
            if e.get("cat") == "cuda_runtime":
                tl.launches.append((e["ts"] * 1e-6, corr))
            elif e.get("cat") in devtrace.Timeline.DEVICE:
                tl.device_s[corr] = tl.device_s.get(corr, 0.0) \
                    + e["dur"] * 1e-6
        tl.spans = self.tracer.drain()
        tl.to_unix = self.tracer.to_unix
        tl.drift_s = self.tracer.unix_offset_stop_s \
            - self.tracer.unix_offset_s
        return tl


@contextlib.contextmanager
def spanned() -> Iterator[Dict[str, Any]]:
    """Inside: slices are ``SpannedSlice``s and a train run is traced
    whole; the dict yielded holds the last run's object under ``run``."""
    from perfbench import serve_cell, train_cell
    from repro_torch.obs import tracer as obs
    kept: Dict[str, Any] = {}
    serve_run, train_run = serve_cell.run, train_cell.run

    def keep_serve(*args, **kwargs):
        out = serve_run(*args, **kwargs)
        kept["run"] = out["run"]
        return out

    def keep_train(*args, **kwargs):
        tr = obs.start(capacity=SLICE_CAPACITY)
        try:
            out = train_run(*args, **kwargs)
        finally:
            if obs.TRACE is tr:
                obs.stop()
        out["run"].events = tr.drain()
        kept["run"] = out["run"]
        return out

    slice_cls = devtrace.Slice
    devtrace.Slice = SpannedSlice
    serve_cell.run, train_cell.run = keep_serve, keep_train
    try:
        yield kept
    finally:
        devtrace.Slice = slice_cls
        serve_cell.run, train_cell.run = serve_run, train_run


def readings(run: Any) -> Dict[str, Any]:
    """The span readings of a run made inside ``spanned``."""
    out: Dict[str, Any] = {}
    tl = run.timeline
    if hasattr(run, "max_batch"):           # a serve run
        if tl is not None:
            out["idle_in_prefill_share.decode"] = \
                hostspans.idle_in_prefill_share(tl, tl.spans, tl.to_unix)
            out["idle_unspanned_share.decode"] = \
                hostspans.idle_unspanned_share(tl, tl.spans, tl.to_unix)
            for kind in hostspans.LOOP_KINDS:
                out[f"idle_in.{kind}"] = hostspans.idle_share(
                    tl, tl.spans, (kind,), tl.to_unix)
            share, n = hostspans.calls_within_share(
                tl, "cudaGraphLaunch", tl.spans, "engine.dispatch",
                tl.to_unix)
            out["graph_launch_in_dispatch_share"] = share
            out["graph_launches"] = n
            out["unix_drift_us"] = tl.drift_s * 1e6
            busy = hostspans.device_s_in_spans(tl, tl.spans,
                                               "engine.prefill", tl.to_unix)
            stream = {e.rid: e.dur for e in tl.spans
                      if e.kind == "dev.prefill" and e.rid in busy}
            if stream:
                out["prefill_busy_ms_p95"] = 1e3 * percentile(
                    [busy[r] for r in stream], 0.95)
                out["prefill_stream_ms_p95"] = 1e3 * percentile(
                    list(stream.values()), 0.95)
                out["prefill_busy_share_of_stream"] = 100.0 * sum(
                    busy[r] for r in stream) / sum(stream.values())
    else:
        out["batch_wait_ms.train"] = hostspans.batch_wait_ms(run)
        out["step_dispatch_ms.train"] = hostspans.step_dispatch_ms(run)
    return {k: v for k, v in out.items() if v is not None}


def main(argv=None) -> Dict[str, Any]:
    from perfbench import run as bench_run
    bench_run._environment()
    with spanned() as kept:
        bench_run.main(argv)
    spans = readings(kept["run"])
    print(json.dumps({"spans": spans}), flush=True)
    return spans


if __name__ == "__main__":
    main()

"""The port's trace exporters and ``Recorder`` against the JAX package's on
the same events: ``chrome_trace``, ``prometheus_text`` and
``cause_summary`` equal, on a hand-made event list (request spans,
shadow links, KV shipping, runtime edges) and on the events the port's
engine and disaggregated server record on the CPU."""
import json

import numpy as np
import pytest
import torch

from repro.obs import events as jevents
from repro.obs import export as jexport
from repro.obs import hist as jhist
from repro.obs import recorder as jrecorder
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.obs import events as E
from repro_torch.obs import tracer as tracer_mod
from repro_torch.serve import (DisaggServer, Request, RequestState,
                               serve_requests)

KW = dict(max_batch=2, max_cache_len=64, page_size=4, max_seq_len=48)


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    tracer_mod.stop()


def _events():
    """Two requests, one replayed as a shadow of a shadow; KV blocks
    shipped and imported (one import without its ship); runtime edges
    on two threads; metas of every kind the exporter renders, one only by
    its ``repr``; a component with no row of its own."""
    t = 100.0
    ev = [
        (t + 0.000, 0.0, E.REQ_SUBMIT, 1, "client", None, 11),
        (t + 0.001, 0.004, E.REQ_ADMIT, 1, "engine", None, 11),
        (t + 0.005, 0.010, E.REQ_PREFILL, 1, "prefill", (0, 3), 12),
        (t + 0.007, 0.0, E.REQ_KV_SHIP, 1, "prefill", (0, 2), 12),
        (t + 0.009, 0.0, E.REQ_KV_IMPORT, 1, "decode", (0, 2), 13),
        (t + 0.012, 0.0, E.REQ_KV_SHIP, 1, "prefill", (1, 1), 12),
        (t + 0.020, 0.0, E.REQ_KV_IMPORT, 1, "decode", (1, 1), 13),
        (t + 0.021, 0.0, E.REQ_KV_IMPORT, 1, "decode", (7, 1), 13),
        (t + 0.022, 0.003, E.REQ_STEP, 1, "engine", 0, 13),
        (t + 0.025, 0.0, E.REQ_DELIVER, 1, "engine", [5, 6], 13),
        (t + 0.002, 0.0, E.REQ_SUBMIT, 2, "router", None, 11),
        (t + 0.003, 0.0, E.REQ_LINK, 3, "router", 2, 11),
        (t + 0.004, 0.0, E.REQ_LINK, 4, "router", 3, 11),
        (t + 0.006, 0.002, E.REQ_ADMIT, 4, "engine", None, 13),
        (t + 0.008, 0.006, E.REQ_PREFILL, 4, "engine", None, 13),
        (t + 0.015, 0.002, E.REQ_STEP, 4, "engine", 1, 13),
        (t + 0.018, 0.0, E.REQ_REPLAY, 3, "router", {"rank": 1}, 11),
        (t + 0.019, 0.0, E.REQ_FINISH, 4, "bench", "finished", 13),
        (t + 0.030, 0.0, E.REQ_FINISH, 1, "mystery", frozenset({3}), 13),
        (t + 0.001, 0.0, E.CONT_POSTED, 7, "core", None, 21),
        (t + 0.004, 0.0, E.CONT_READY, 7, "core", None, 22),
        (t + 0.005, 0.001, E.CONT_RAN, 7, "core", "sched|enq", 22),
        (t + 0.006, 0.0005, E.PROGRESS_SCAN, -1, "core", 3, 21),
    ]
    mine = [E.Event(*e) for e in ev]
    theirs = [jevents.Event(*e) for e in ev]
    return mine, theirs


def _histograms():
    mine, theirs = {}, {}
    rng = np.random.default_rng(0)
    for edge in E.LIFECYCLE_EDGES:
        for pkey in ("sched|enq", "poll|enq|pr2"):
            values = rng.exponential(40.0, 25).tolist() + [3e7]
            mine[edge, pkey] = obs.Histogram()
            theirs[edge, pkey] = jhist.Histogram()
            for v in values:
                mine[edge, pkey].observe(v)
                theirs[edge, pkey].observe(v)
    return mine, theirs


def test_chrome_trace_and_prometheus_equal_the_reference():
    mine, theirs = _events()
    hmine, htheirs = _histograms()
    a = obs.chrome_trace(mine, histograms=hmine, dropped=3)
    b = jexport.chrome_trace(theirs, histograms=htheirs, dropped=3)
    assert a == b
    procs = {e["args"]["name"] for e in a["traceEvents"]
             if e.get("name") == "process_name"}
    assert procs == {"runtime", "request 1", "request 2"}
    metrics = {"tokens_per_s": 12.5, "finished": 3, "paged": True,
               "name": "x", "p99 ms": 4.0}
    transport = {"sends": 9, "bytes": 4096,
                 "per_tag": {"kv": {"sends": 4, "bytes": 2048}}}
    for kw in ({}, dict(metrics=metrics, transport=transport),
               dict(metrics=metrics, histograms=hmine, dropped=2,
                    prefix="port")):
        ref = dict(kw)
        if "histograms" in ref:
            ref["histograms"] = htheirs
        assert obs.prometheus_text(**kw) == jexport.prometheus_text(**ref)


def test_cause_summary_equals_the_reference():
    mine, theirs = _events()
    hmine, htheirs = _histograms()
    rec, ref = obs.Recorder(), jrecorder.Recorder()
    rec.events, ref.events = mine, theirs
    rec.histograms, ref.histograms = hmine, htheirs
    rec.dropped = ref.dropped = 5
    got = rec.cause_summary()
    assert got == ref.cause_summary()
    assert got["requests"] == 2 and got["shipping_ms_mean"] > 0
    assert rec.by_kind() == ref.by_kind()
    assert rec.prometheus({"a": 1.0}) == ref.prometheus({"a": 1.0})


@pytest.fixture(scope="module")
def small_model():
    cfg = get_config("paper_demo", reduced=True, dtype=torch.float32,
                     param_dtype=torch.float32)
    return cfg, lm.init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("tier", ["engine", "disagg"])
def test_recorded_port_events_export_as_the_reference(small_model, tier,
                                                      tmp_path):
    """A traced serve on the CPU: the recorder's Chrome trace, Prometheus
    text and cause split equal the reference exporters' on the same
    events; every request has its own track; shipping shows only where
    KV crosses the disaggregated transport."""
    cfg, params = small_model
    prompts = [list(range(1, 12)), [2, 3, 4, 5, 6]]
    rec = obs.Recorder()
    with rec:
        if tier == "engine":
            reqs = serve_requests(cfg, params,
                                  [Request(p, 6) for p in prompts],
                                  timeout=120, device="cpu", **KW)
        else:
            srv = DisaggServer(cfg, params, device="cpu", **KW)
            reqs = [Request(p, 6) for p in prompts]
            for r in reqs:
                srv.submit(r)
            srv.close_intake()
            srv.run(timeout=120)
            srv.shutdown()
    assert all(r.req_state is RequestState.FINISHED for r in reqs)
    assert rec.events and not rec._active
    ref = jrecorder.Recorder()
    ref.events = [jevents.Event(*e) for e in rec.events]
    for key, h in rec.histograms.items():
        ref.histograms[key] = jhist.Histogram()
        for name in ("counts", "total", "count", "max"):
            setattr(ref.histograms[key], name, getattr(h, name))
    assert rec.chrome_trace() == ref.chrome_trace()
    assert rec.prometheus() == ref.prometheus()
    causes = rec.cause_summary()
    assert causes == ref.cause_summary()
    assert causes["requests"] == 2 and causes["compute_ms_mean"] > 0
    assert (causes["shipping_ms_mean"] > 0) == (tier == "disagg")
    path = rec.write(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    tracks = {e["pid"] for e in doc["traceEvents"]
              if e["name"].startswith("req.")}
    assert tracks == {r.req_id + 1 for r in reqs}

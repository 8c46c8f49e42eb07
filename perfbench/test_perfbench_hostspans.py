"""The span readers: host spans on a hand-made timeline with known
overlaps, the trainer's spans over a window, the ``dev.*`` metrics on
hand-made events, the wiring of ``span_run`` through whole runs at a
reduced size on the CPU, and (``gpu``) the shared clock on the card."""
import pytest

from perfbench import hostspans, spec
from perfbench.devtrace import Timeline
from perfbench.serve_cell import ServeRun
from perfbench.train_cell import TrainRun
from repro_torch.obs.events import Event

OFFSET = 1000.0     # the tracer's clock is OFFSET s behind the timeline's


def _ev(kind, start, dur, rid=-1):
    return Event(start - OFFSET, dur, kind, rid, "engine", None, 1)


def _timeline(kernels, host=()):
    """A ``devtrace.Timeline`` of kernels and runtime calls at the given
    seconds, its document's base at 0."""
    def x(cat, name, s, e):
        return {"ph": "X", "cat": cat, "name": name, "ts": s * 1e6,
                "dur": (e - s) * 1e6}
    tl = Timeline([x("kernel", "k", s, e) for s, e in kernels]
                  + [x("cuda_runtime", n, s, e) for n, s, e in host], 0.0)
    tl.base_s = 0.0
    return tl


def _to_unix(ts):
    return ts + OFFSET


@pytest.mark.parametrize("spans, in_prefill, unspanned", [
    # kernels at [0, 1] and [2, 3]: 1 s idle
    ([("engine.prefill", 1.0, 0.5)], 50.0, 50.0),
    ([("engine.prefill", 1.2, 0.2), ("engine.prefill", 1.3, 0.3)], 40.0,
     60.0),
    ([("engine.dispatch", 1.5, 0.25), ("cont.ran", 1.6, 0.3),
      ("progress.scan", 1.0, 0.2)], 0.0, 40.0),
    ([("engine.prefill", 0.0, 3.0), ("req.step", 1.0, 1.0)], 100.0, 0.0),
])
def test_idle_shares_on_a_hand_made_timeline(spans, in_prefill, unspanned):
    tl = _timeline([(0.0, 1.0), (2.0, 3.0)])
    events = [_ev(k, s, d) for k, s, d in spans]
    assert hostspans.idle_in_prefill_share(tl, events, _to_unix) == \
        pytest.approx(in_prefill)
    assert hostspans.idle_unspanned_share(tl, events, _to_unix) == \
        pytest.approx(unspanned)


def test_idle_shares_with_no_idle_time_or_no_span_read_nothing():
    busy = _timeline([(0.0, 1.0), (0.5, 2.0)])
    assert hostspans.idle_gaps(busy) == []
    assert hostspans.idle_in_prefill_share(
        busy, [_ev("engine.prefill", 0.0, 1.0)], _to_unix) is None
    idle = _timeline([(0.0, 1.0), (2.0, 3.0)])
    assert hostspans.idle_unspanned_share(idle, [], _to_unix) is None


def test_the_clock_check_counts_the_calls_inside_their_spans():
    tl = _timeline([], host=[("cudaGraphLaunch", 1.00005, 1.0001),
                             ("cudaGraphLaunch", 2.0, 2.0002),
                             ("cudaGraphLaunch", 3.0, 3.0001),
                             ("cudaLaunchKernel", 5.0, 5.1)])
    events = [_ev("engine.dispatch", 1.0, 0.0001),     # first: inside
              _ev("engine.dispatch", 2.00005, 0.0001),  # second: by slack
              _ev("engine.dispatch", 3.01, 0.001),      # third: outside
              _ev("engine.prefill", 3.0, 1.0)]
    share, n = hostspans.calls_within_share(
        tl, "cudaGraphLaunch", events, "engine.dispatch", _to_unix)
    assert n == 3 and share == pytest.approx(200.0 / 3)
    assert hostspans.calls_within_share(
        tl, "cudaMemcpyAsync", events, "engine.dispatch", _to_unix) == \
        (None, 0)


def test_a_spans_device_time_is_what_was_launched_inside_it():
    """Each operation counts for the span its runtime call starts in, by
    its correlation; a span the slice did not record whole is left out."""
    tl = _timeline([])
    tl.launches = [(0.5, 1), (1.1, 2), (1.2, 3), (1.9, 4), (2.5, 5),
                   (3.2, 6), (4.0, 7)]
    tl.device_s = {1: 9.0, 2: 0.01, 3: 0.02, 4: 0.005, 5: 0.3, 6: 0.04}
    events = [_ev("engine.prefill", 0.2, 0.5, rid=10),   # from 0.2: cut
              _ev("engine.prefill", 1.0, 1.0, rid=11),
              _ev("engine.prefill", 3.0, 0.5, rid=12),
              _ev("engine.dispatch", 2.4, 0.2)]
    got = hostspans.device_s_in_spans(tl, events, "engine.prefill",
                                      _to_unix)
    assert got == pytest.approx({11: 0.035, 12: 0.04})
    tl.launches = []
    assert hostspans.device_s_in_spans(tl, events, "engine.prefill",
                                       _to_unix) == {}


def test_the_trainer_readers_take_the_windows_spans():
    r = TrainRun({"job": {"batch": 1, "seq_len": 8}}, {}, "float32")
    r.t_open, r.t_close = 10.0, 20.0
    r.host_s = [1.0] * 4
    r.events = [Event(9.0, 0.5, "data.wait", 0, "data", None, 1),
                Event(11.0, 0.02, "data.wait", 1, "data", None, 1),
                Event(15.0, 0.01, "data.wait", 3, "data", None, 1),
                Event(21.0, 0.5, "data.wait", 5, "data", None, 1),
                Event(12.0, 0.8, "train.dispatch", -1, "train", None, 1),
                Event(13.0, 0.6, "train.dispatch", -1, "train", None, 1),
                Event(9.5, 5.0, "train.dispatch", -1, "train", None, 1)]
    assert hostspans.batch_wait_ms(r) == pytest.approx(7.5)
    assert hostspans.step_dispatch_ms(r) == pytest.approx(700.0)
    r.events = []
    assert hostspans.batch_wait_ms(r) == 0.0
    assert hostspans.step_dispatch_ms(r) is None


@pytest.mark.parametrize("metric, kind, want", [
    ("step_device_ms.decode", "dev.step", 3.0),
    ("prefill_stream_ms_p95.decode", "dev.prefill", 8.0),
])
def test_the_dev_span_readers(metric, kind, want):
    r = ServeRun({"engine": {"max_batch": 4}}, {}, "bfloat16")
    r.t_open, r.t_close = 0.0, 10.0
    reader = spec.reader(metric)
    assert reader.read(r) is None           # a program without the events
    durs = [0.001, 0.002, 0.003, 0.004, 0.009]
    r.events = [Event(1.0 + i, d, kind, -1, "engine", None, 1)
                for i, d in enumerate(durs)]
    r.events += [Event(11.0, 1.0, kind, -1, "engine", None, 1),
                 Event(2.0, 1.0, "engine.prefill", -1, "engine", None, 1)]
    assert reader.read(r) == pytest.approx(want)


@pytest.mark.parametrize("cell, keys", [
    ("mamba2-gen", ()),
    ("mamba2-train", ("batch_wait_ms.train", "step_dispatch_ms.train")),
])
def test_span_run_arms_the_slice_and_the_train_window(cell, keys):
    """Through whole runs at a reduced size on the CPU: the slice's session
    holds the serve loop's spans and its timeline keeps the document's
    base; a train run's spans are read over its window."""
    from perfbench import devtrace, serve_cell, train_cell
    from perfbench.span_run import spanned, readings
    from perfbench.testing import run_small
    before = (devtrace.Slice, serve_cell.run, train_cell.run)
    with spanned() as kept:
        res = run_small(cell, seconds=1.5, trace=True)
    assert (devtrace.Slice, serve_cell.run, train_cell.run) == before
    assert res["correct"], res["checks"]
    run = kept["run"]
    tl = run.timeline
    assert tl.base_s > 1e9 and abs(tl.drift_s) < 1e-3
    got = readings(run)
    assert set(keys) <= set(got)
    if cell == "mamba2-gen":
        kinds = {e.kind for e in tl.spans}
        assert {"engine.dispatch", "cont.ran"} <= kinds
        # the window's own session is untouched
        assert "engine.dispatch" in {e.kind for e in run.events}
    else:
        assert 0.0 <= got["batch_wait_ms.train"]
        assert 0.0 < got["step_dispatch_ms.train"]


@pytest.mark.gpu
def test_the_clock_check_holds_on_the_card(card):
    """A traced mamba2-gen slice at the cell's size: at least 99% of the
    profiler's ``cudaGraphLaunch`` calls lie inside an ``engine.dispatch``
    span mapped onto its clock (within 0.1 ms)."""
    import time

    from perfbench import harness
    from perfbench.span_run import readings, spanned
    bench = spec.benchmark()
    cell = spec.cell("mamba2-gen")
    conf = spec.config(cell["config"], bench)
    with spanned() as kept:
        res = harness.run_cell(bench, cell, conf, 3000000017, 6.0, True,
                               card, time.monotonic())
    got = readings(kept["run"])
    print("clock check:", got)
    assert res["correct"]
    assert got["graph_launches"] >= 50        # a 2-s slice, ~47 steps/s
    assert got["graph_launch_in_dispatch_share"] >= 99.0

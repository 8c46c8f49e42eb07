"""The port's spans of its own work, on the CPU: the serve loop's
``engine.*`` spans (dense, paged and speculative paths), the trainer's
``data.wait`` and ``train.dispatch``, nothing recorded and no CUDA event
made with tracing off, the prefetch bounded by consumption, and the
tracer's stamps on ``torch.profiler``'s clock. The test marked ``gpu``
records the ``dev.*`` device times on the card and skips elsewhere:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_obs_spans.py
"""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import Engine
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticTokenSource
from repro_torch.launch.train import upload
from repro_torch.models import lm
from repro_torch.obs import events as E
from repro_torch.obs import tracer as tracer_mod
from repro_torch.optim import OptConfig
from repro_torch.serve import Request, RequestState, ServeEngine
from repro_torch.train.train_step import init_train_state, make_train_step


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    tracer_mod.stop()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoCudaEvent:
    def __init__(self, *args, **kwargs):
        raise AssertionError("a CUDA event was made")


ENGINES = {
    "dense": ("mamba2_370m", dict(paged=False, max_batch=2)),
    "paged": ("paper_demo", dict(max_batch=2, max_cache_len=64,
                                 page_size=4, max_seq_len=48)),
    "speculative": ("paper_demo", dict(max_batch=2, max_cache_len=64,
                                       page_size=4, max_seq_len=48,
                                       speculate=2)),
}


def _serve(path, traced, device="cpu"):
    name, kw = ENGINES[path]
    if device == "cpu":
        cfg = get_config(name, reduced=True, dtype=torch.float32,
                         param_dtype=torch.float32)
    else:   # full width (the kernels' head sizes), two layers
        cfg = dataclasses.replace(get_config(
            name, dtype=torch.float32, param_dtype=torch.float32),
            n_layers=2)
    params = lm.init_params(cfg, seed=0, device=device)
    eng = ServeEngine(cfg, params, device=device, **kw)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 200, n).tolist() for n in (9, 5, 12, 7)]
    reqs = [Request(p, k) for p, k in zip(prompts, (6, 1, 5, 4))]
    if traced:
        tracer_mod.start()
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    try:
        eng.run(timeout=120)
    finally:
        eng.shutdown()
    events = tracer_mod.stop().drain() if traced else []
    assert all(r.req_state is RequestState.FINISHED for r in reqs)
    return eng, reqs, events


@pytest.mark.parametrize("path", sorted(ENGINES))
def test_the_serve_loop_spans_its_prefills_and_dispatches(path,
                                                          monkeypatch):
    """One ``engine.dispatch`` a step, one ``engine.prefill`` a placement,
    and no ``dev.*`` event (nor any CUDA event) on the CPU. With tracing
    off the same run records nothing and asks for no timing events;
    tracing changes no token."""
    monkeypatch.setattr(torch.cuda, "Event", _NoCudaEvent)
    eng, reqs, events = _serve(path, traced=True)
    kinds = [e.kind for e in events]
    assert kinds.count(E.ENGINE_DISPATCH) == eng.stats["steps"] > 0
    assert sum(e.dur for e in events if e.kind == E.ENGINE_DISPATCH) == \
        pytest.approx(eng.stats["dispatch_s"])
    prefills = [e for e in events if e.kind == E.ENGINE_PREFILL]
    assert len(prefills) == eng.stats["prefills"] == len(reqs)
    assert sorted((e.rid, e.meta) for e in prefills) == sorted(
        (r.req_id, len(r.prompt)) for r in reqs)
    assert not [k for k in kinds if k.startswith("dev.")]

    def touched(*args, **kwargs):
        raise AssertionError("timing events asked for with tracing off")
    monkeypatch.setattr(ServeEngine, "_timing_events", touched)
    _, untraced, events = _serve(path, traced=False)
    assert events == [] and tracer_mod.TRACE is None
    assert [r.tokens for r in untraced] == [r.tokens for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(ENGINES))
def test_the_card_times_each_step_and_prefill(path):
    """On the card, one ``dev.step`` a step and one ``dev.prefill`` a
    placement, each stamped at its dispatch, with device seconds from its
    timing events, the pairs reused once their work is done; with tracing
    off no timing event is made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device times are recorded there")
    card = torch.device("cuda", 0)
    made = []
    event_cls = torch.cuda.Event

    def counted(*args, **kwargs):       # a TensorOp's own event untimed
        if kwargs.get("enable_timing"):
            made.append(1)
        return event_cls(*args, **kwargs)
    try:
        torch.cuda.Event = counted
        eng, reqs, events = _serve(path, traced=True, device=card)
    finally:
        torch.cuda.Event = event_cls
    steps = [e for e in events if e.kind == E.DEV_STEP]
    prefills = [e for e in events if e.kind == E.DEV_PREFILL]
    dispatches = [e for e in events if e.kind == E.ENGINE_DISPATCH]
    assert len(steps) == len(dispatches) == eng.stats["steps"] > 0
    assert len(prefills) == eng.stats["prefills"] == len(reqs)
    assert all(0 < e.dur < 1.0 for e in steps + prefills)
    for d, s in zip(dispatches, steps):     # the replay inside its dispatch
        assert d.ts <= s.ts <= d.ts + d.dur
    assert sorted((e.rid, e.meta) for e in prefills) == sorted(
        (r.req_id, len(r.prompt)) for r in reqs)
    assert 0 < len(made) < 2 * (len(steps) + len(prefills))    # reused
    made.clear()
    try:
        torch.cuda.Event = counted
        _, untraced, _ = _serve(path, traced=False, device=card)
    finally:
        torch.cuda.Event = event_cls
    assert made == []
    assert all(r.req_state is RequestState.FINISHED for r in untraced)


class _CountingSource(SyntheticTokenSource):
    """Records every batch index it was asked for."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.made = []
        self._lock = threading.Lock()

    def make_batch(self, index):
        with self._lock:
            self.made.append(index)
        return super().make_batch(index)


def _plain(index):
    cfg = get_config("paper_demo", reduced=True)
    return SyntheticTokenSource(cfg, global_batch=2,
                                seq_len=16).make_batch(index)


@pytest.mark.parametrize("depth", [1, 3])
def test_the_prefetch_runs_at_most_depth_batches_ahead_of_the_consumer(
        depth):
    cfg = get_config("paper_demo", reduced=True)
    src = _CountingSource(cfg, global_batch=2, seq_len=16)
    engine = Engine()
    pipe = PrefetchPipeline(src, engine, depth=depth, max_batches=40)
    try:
        for k in range(6):
            time.sleep(0.05)        # fills that could run ahead, would
            assert len(src.made) <= k + depth, (k, src.made)
            batch = pipe.get_next()
            np.testing.assert_array_equal(batch["tokens"],
                                          _plain(k)["tokens"])
        deadline = time.monotonic() + 10.0     # the last fills, posted
        while len(src.made) < 6 + depth and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sorted(src.made) == list(range(6 + depth))
    finally:
        pipe.close()
        engine.shutdown()


def test_a_restarted_prefetch_starts_at_its_first_index():
    cfg = get_config("paper_demo", reduced=True)
    src = _CountingSource(cfg, global_batch=2, seq_len=16)
    engine = Engine()
    pipe = PrefetchPipeline(src, engine, depth=2, max_batches=8, start=5)
    try:
        got = [b["tokens"] for b in pipe]
        assert len(got) == 3 and sorted(src.made) == [5, 6, 7]
        np.testing.assert_array_equal(got[0], _plain(5)["tokens"])
    finally:
        pipe.close()
        engine.shutdown()


class _GatedSource(SyntheticTokenSource):
    """Makes a batch whose index is in ``gated`` only once its gate is
    set."""

    def __init__(self, *args, gated=(), **kwargs):
        super().__init__(*args, **kwargs)
        self.gates = {i: threading.Event() for i in gated}

    def make_batch(self, index):
        gate = self.gates.get(index)
        if gate is not None:
            assert gate.wait(30.0)
        return super().make_batch(index)


def test_the_trainer_spans_its_batch_waits_and_step_dispatches():
    """Batches 0, 2 and 5 are made only 50 ms after the loop began to wait
    for them: each has a ``data.wait`` span inside its ``get_next`` call
    of at least that sleep, so the spans sum to at least the sleeps the
    loop waited for; each step is one ``train.dispatch``."""
    sleep_s = 0.05
    cfg = get_config("paper_demo", reduced=True, dtype=torch.float32,
                     param_dtype=torch.float32)
    opt = OptConfig(lr=1e-3)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, opt)
    src = _GatedSource(cfg, global_batch=2, seq_len=16, gated=(0, 2, 5))
    engine = Engine()
    tr = tracer_mod.start()
    pipe = PrefetchPipeline(src, engine, depth=2, max_batches=6)

    def release(gate, waits0):      # once the loop waits, after the sleep
        while pipe.stats["get_waits"] == waits0:
            time.sleep(0.001)
        time.sleep(sleep_s)
        gate.set()
    calls = []
    try:
        for k in range(6):
            if k in src.gates:
                threading.Thread(target=release, daemon=True, args=(
                    src.gates[k], pipe.stats["get_waits"])).start()
            t0 = tr.now()
            batch = pipe.get_next()
            calls.append((t0, tr.now()))
            state, _ = step(state, upload(batch, torch.device("cpu")))
    finally:
        tracer_mod.stop()
        for gate in src.gates.values():
            gate.set()
        pipe.close()
        engine.shutdown()
    events = tr.drain()
    assert [e.kind for e in events].count(E.TRAIN_DISPATCH) == 6
    waits = {e.rid: e for e in events if e.kind == E.DATA_WAIT}
    assert set(src.gates) <= set(waits)
    for k, e in waits.items():
        assert calls[k][0] <= e.ts and e.ts + e.dur <= calls[k][1]
    assert all(waits[k].dur >= sleep_s for k in src.gates)
    assert sum(e.dur for e in waits.values()) >= sleep_s * len(src.gates)


def test_a_tracer_stamp_lands_on_the_profilers_clock(tmp_path):
    """A ``record_function`` marker inside a tracer span, mapped through
    ``to_unix`` and the trace's ``baseTimeNanoseconds``, lies where the
    span does, within 1 ms; the offset drifts by less than that."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = tracer_mod.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = tr.now()
        with record_function("marker"):
            torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.02)
        tr.evt("test.span", ts=t0, dur=tr.now() - t0)
    tracer_mod.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_s = doc["baseTimeNanoseconds"] * 1e-9
    marker = next(e for e in doc["traceEvents"] if e.get("name") == "marker")
    span = next(e for e in tr.drain() if e.kind == "test.span")
    start = tr.to_unix(span.ts) - base_s
    # the marker lies inside the span (a clock off by more than 1 ms
    # either way puts one of its ends outside)
    assert start - 1e-3 < marker["ts"] * 1e-6
    assert (marker["ts"] + marker["dur"]) * 1e-6 < start + span.dur + 1e-3
    assert abs(tr.unix_offset_stop_s - tr.unix_offset_s) < 1e-3

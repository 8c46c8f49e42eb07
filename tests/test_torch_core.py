"""The port's continuation runtime: ``TensorOp`` and the serving loop's use
of it.

On the CPU a real ``TensorOp`` is complete at once (the work ran
synchronously), so the poll path the card takes is exercised here with a
held-back test double: an op whose event reports "not yet" until the test
releases it, and which fails the test if anything blocks on it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.core import (ContinueFlags, Engine, PredicateOp, TensorOp,
                              TimerOp)
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine, greedy_generate
from repro_torch.serve import engine as engine_mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _HeldEvent:
    """Stands in for a CUDA event: pending until released; waiting on it
    is a test failure (the serve loop must only ever poll)."""

    def __init__(self, released: bool) -> None:
        self.released = released
        self.queries = 0

    def query(self) -> bool:
        self.queries += 1
        return self.released

    def synchronize(self) -> None:
        raise AssertionError("something blocked on a step's completion")


@pytest.fixture
def held_ops(monkeypatch):
    """Route the serve engine's TensorOps through held-back events.
    ``state["auto"]`` releases new ops at creation."""
    state = {"events": [], "auto": False}

    class HeldOp(TensorOp):
        def __init__(self, tensor, payload=None):
            super().__init__(tensor, payload)
            self._event = _HeldEvent(state["auto"])
            state["events"].append(self._event)

    monkeypatch.setattr(engine_mod, "TensorOp", HeldOp)
    return state


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("paper_demo", reduced=True, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    tcfg = get_config("paper_demo", reduced=True, dtype=torch.float32,
                      param_dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return tcfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   tcfg, "cpu")


def test_engine_polls_and_runs_continuations_only_after_release(model,
                                                                held_ops):
    tcfg, tp = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in (7, 12)]
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=2,
                      max_cache_len=64, page_size=8, max_inflight=2)
    reqs = [Request(p, 5) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    pending0 = TensorOp.PENDING_AT_FIRST_POLL
    for _ in range(10):
        eng.step()        # never blocks: a wait would raise in the double
    events = held_ops["events"]
    # two prefills, then the in-flight window (2 steps) is full
    assert len(events) == 4 and eng._inflight == 2
    assert all(ev.queries > 0 for ev in events)            # polled
    assert all(r.delivered == 0 for r in reqs)             # nothing ran
    assert TensorOp.PENDING_AT_FIRST_POLL - pending0 == 4
    # a stream completes its work in order: release the ops that way
    events[0].released = True                              # first prefill
    eng.step()
    assert [r.delivered for r in reqs] == [1, 0]
    assert len(events) == 4                                # window still full
    events[1].released = True                              # second prefill
    eng.step()
    assert [r.delivered for r in reqs] == [1, 1]
    events[2].released = True                              # first step
    eng.step()
    assert [r.delivered for r in reqs] == [2, 2]
    assert len(events) == 5                                # a step slot freed
    held_ops["auto"] = True
    for ev in events:
        ev.released = True
    eng.run(timeout=60)
    for p, r in zip(prompts, reqs):
        want = greedy_generate(tcfg, tp, p[None], 5, 64, device="cpu")[0]
        assert r.tokens == want.tolist()
    assert eng.metrics()["pages_in_use"] == 0


def test_cpu_tensor_op_is_complete_at_once():
    pending0 = TensorOp.PENDING_AT_FIRST_POLL
    t = torch.arange(4)
    op = TensorOp(t)
    assert op.done() and op.status.payload is t
    assert TensorOp(t, payload="p").status.payload == "p"
    assert TensorOp.PENDING_AT_FIRST_POLL == pending0


def test_continue_when_on_tensor_op_with_enqueue_complete():
    eng = Engine()
    try:
        cr = eng.continue_init()
        seen = []
        flag = eng.continue_when(TensorOp(torch.ones(2), payload="x"),
                                 lambda st, d: seen.append((st[0].payload, d)),
                                 "ctx", status=[None], cr=cr,
                                 flags=ContinueFlags(enqueue_complete=True))
        assert flag is False and seen == []      # deferred, not inline
        eng.tick()
        assert seen == [("x", "ctx")]
        assert cr.test() is True
    finally:
        eng.shutdown()


def test_continue_all_waits_for_every_op():
    eng = Engine()
    try:
        cr = eng.continue_init()
        gate = {"open": False}
        ops = [TensorOp(torch.zeros(1)), PredicateOp(lambda: gate["open"]),
               TimerOp(0.0)]
        seen = []
        flag = eng.continue_all(ops, lambda sts, d: seen.append(len(sts)),
                                None, statuses=[None] * 3, cr=cr)
        assert flag is False
        eng.tick()
        assert seen == []
        gate["open"] = True
        cr.wait(timeout=5)
        assert seen == [3]
    finally:
        eng.shutdown()

"""The port's step graphs (``serve.graphs.StepGraph``, the counterpart of
the reference's ``jax.jit`` of a serve step) and its streaming front end
(``serve.api.ServeClient``).

On the CPU a ``StepGraph`` runs its step eagerly on the engine's static
buffers, so these tests hold that the engine reads and writes a step's
inputs only through buffers whose addresses never change (what a CUDA
graph replay needs) and still emits greedy decoding's tokens (float32,
reduced configs). The tests marked ``gpu`` capture and replay on the card
and skip elsewhere:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_graphs.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention, rmsnorm
from repro_torch.models import lm
from repro_torch.serve import (EngineLike, GenerationConfig, Request,
                               RequestState, ServeClient, ServeEngine,
                               StepGraph, greedy_generate)
from repro_torch.serve.graphs import KERNEL_MODULES

MARGIN = 1e-3      # top-2 logit gap below which greedy tokens may flip


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(name, **kw):
    return get_config(name, dtype=torch.float32, param_dtype=torch.float32,
                      **kw)


def _prompts(seed, vocab, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lengths]


def _static_addresses(eng):
    """Every buffer a step graph reads or writes, by address."""
    bufs = {"tokens": eng._tokens, "meta": eng._meta}
    if eng.paged:
        bufs["tables"] = eng._tables_dev
        bufs.update(eng.pool.arrays)
    else:
        bufs.update(eng._cache)
    return {name: t.data_ptr() for name, t in bufs.items()}


# ---------------------------------------------------------------- the CPU
def test_step_graph_runs_eagerly_on_the_cpu():
    calls = []

    def step():
        calls.append(1)
        return torch.full((2,), len(calls))

    g = StepGraph(step, torch.device("cpu"))
    assert g.graph is None and g.launches == ()
    assert g().tolist() == [1, 1] and g().tolist() == [2, 2]
    assert g.replays == 2 and len(calls) == 2
    with pytest.raises(ValueError, match="no step graphs"):
        StepGraph(step, torch.device("meta"))
    assert {m.__name__.rsplit(".", 1)[1] for m in KERNEL_MODULES} == {
        "flash_attention", "paged_attention", "rmsnorm", "ssd_scan"}


@pytest.mark.parametrize("name,kw", [
    ("paper_demo", dict(page_size=8, max_seq_len=64)),
    ("paper_demo", dict(page_size=8, max_seq_len=64, speculate=3)),
    ("mamba2_370m", dict(max_cache_len=64)),
    ("paper_demo", dict(page_size=8, max_seq_len=64, fused=False)),
    ("paper_demo", dict(page_size=8, max_seq_len=64, speculate=3,
                        fused=False)),
])
def test_engine_steps_through_static_buffers(name, kw):
    """Every decode or verify step is one ``StepGraph`` call on buffers
    allocated at construction and never rebound, and the tokens equal
    the eager greedy oracle's."""
    cfg = _f32(name, reduced=True)
    params = lm.init_params(cfg, seed=0, device="cpu")
    eng = ServeEngine(cfg, params, device="cpu", max_batch=3, **kw)
    graph = eng._verify_graph if eng.speculate else eng._decode_graph
    other = eng._decode_graph if eng.speculate else eng._verify_graph
    assert isinstance(graph, StepGraph) and other is None
    before = _static_addresses(eng)
    motif = np.array([9, 4, 27, 4, 1])
    prompts = _prompts(3, cfg.vocab_size, (5, 17, 9)) + [np.tile(motif, 3)]
    budgets = [7, 12, 1, 10]
    reqs = [Request(p, n) for p, n in zip(prompts, budgets)]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    assert _static_addresses(eng) == before
    assert graph.replays == eng.stats["steps"] > 0
    assert eng.metrics().get("pages_in_use", 0) == 0 and eng.idle
    for p, n, r in zip(prompts, budgets, reqs):
        assert r.req_state is RequestState.FINISHED
        assert r.tokens == greedy_generate(cfg, params, p[None], n, 64,
                                           device="cpu")[0].tolist()


@pytest.mark.parametrize("speculate", [0, 2])
def test_serve_client_streams_the_engines_tokens(speculate):
    """Tokens streamed through ``ServeClient`` (its own loop thread drives
    the engine) equal ``engine.run()``'s for the same requests."""
    cfg = _f32("paper_demo", reduced=True)
    params = lm.init_params(cfg, seed=0, device="cpu")
    kw = dict(device="cpu", max_batch=2, page_size=8, max_seq_len=48)
    prompts = _prompts(4, cfg.vocab_size, (6, 13, 21)) \
        + [np.tile([3, 8, 5], 5)]
    eng = ServeEngine(cfg, params, **kw)
    reqs = [Request(p, 9) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    eng.shutdown()
    served = ServeEngine(cfg, params, speculate=speculate, **kw)
    assert isinstance(served, EngineLike)
    with ServeClient(engine=served) as client:
        session = client.session(max_tokens=9)
        streams = [session.generate(p) for p in prompts]
        got = [list(s) for s in streams]
        assert [s.result(timeout=60) for s in streams] == got
        m = client.metrics()
    assert got == [r.tokens for r in reqs]
    assert all(s.reason == "finished" for s in streams)
    assert m["pages_in_use"] == 0
    assert m["verify_steps"] == (m["steps"] if speculate else 0)


def test_serve_client_builds_its_own_engine():
    cfg = _f32("paper_demo", reduced=True)
    params = lm.init_params(cfg, seed=0, device="cpu")
    p = _prompts(5, cfg.vocab_size, (11,))[0]
    want = greedy_generate(cfg, params, p[None], 6, 64,
                           device="cpu")[0].tolist()
    with ServeClient(cfg, params, device="cpu", max_batch=2, page_size=8,
                     max_seq_len=32) as client:
        stream = client.generate(p, GenerationConfig(max_tokens=6))
        assert stream.result(timeout=60) == want
        assert stream.text().result(timeout=60) == " ".join(map(str, want))
    with pytest.raises(ValueError, match="needs"):
        ServeClient()
    with pytest.raises(TypeError, match="EngineLike"):
        ServeClient(engine=object())


# --------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: step graphs are captured only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_model(dev, n_layers=2):
    """``paper_demo`` at full width (the kernels' head_dim 64), cut to
    ``n_layers``, in float32."""
    cfg = dataclasses.replace(_f32("paper_demo"), n_layers=n_layers)
    return cfg, lm.init_params(cfg, seed=0, device=dev)


def _tie_free(cfg, params, prompt, tokens):
    seq = np.concatenate([prompt, tokens])
    logits = lm.lm_forward(params, {"tokens": torch.as_tensor(
        seq[None], dtype=torch.int32, device=params["embed"]["tokens"]
        .device)}, cfg)[0].float()
    top2 = torch.topk(logits[len(prompt) - 1:len(seq) - 1], 2, dim=-1).values
    small = ((top2[:, 0] - top2[:, 1]) < MARGIN).nonzero()
    return len(tokens) if len(small) == 0 else int(small[0, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("speculate", [0, 3])
def test_captured_steps_match_eager_greedy_on_card(card, speculate):
    """Replayed decode (or verify) graphs give the eager oracle's tokens,
    one replay a step, and each replay adds its kernels' launches."""
    cfg, params = _card_model(card)
    eng = ServeEngine(cfg, params, device=card, max_batch=4, page_size=16,
                      max_seq_len=128, speculate=speculate)
    graph = eng._verify_graph if speculate else eng._decode_graph
    assert graph.graph is not None
    per_replay = dict((m.__name__, n) for m, n in graph.launches)
    assert per_replay == {paged_attention.__name__: cfg.n_layers,
                          rmsnorm.__name__: 2 * cfg.n_layers + 1}
    motif = np.array([101, 7, 3000, 7])
    prompts = [np.tile(motif, 10)] + _prompts(6, cfg.vocab_size, (33, 70))
    reqs = [Request(p, 24) for p in prompts]
    paged_attention.LAUNCHES = 0
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    torch.cuda.synchronize()
    steps = eng.stats["steps"]
    assert graph.replays == steps > 0
    assert paged_attention.LAUNCHES == cfg.n_layers * (
        steps + eng.stats["suffix_steps"])
    if speculate:
        assert eng.stats["draft_accepted"] > 0
    assert eng.metrics()["pages_in_use"] == 0
    for p, r in zip(prompts, reqs):
        want = greedy_generate(cfg, params, p[None], 24, 128,
                               device=card)[0].tolist()
        n = _tie_free(cfg, params, p, np.asarray(want))
        assert r.tokens[:n] == want[:n]
    eng.shutdown()


@pytest.mark.gpu
def test_mamba2_dense_step_graph_on_card(card):
    cfg = dataclasses.replace(_f32("mamba2_370m"), n_layers=2)
    params = lm.init_params(cfg, seed=0, device=card)
    eng = ServeEngine(cfg, params, device=card, max_batch=3)
    assert not eng.paged and eng._decode_graph.graph is not None
    prompts = _prompts(7, cfg.vocab_size, (64, 131, 9))
    reqs = [Request(p, 12) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    assert eng._decode_graph.replays == eng.stats["steps"] > 0
    for p, r in zip(prompts, reqs):
        want = greedy_generate(cfg, params, p[None], 12, 256,
                               device=card)[0].tolist()
        n = _tie_free(cfg, params, p, np.asarray(want))
        assert r.tokens[:n] == want[:n]
    eng.shutdown()


@pytest.mark.gpu
def test_failed_capture_raises_and_the_card_stays_usable(card):
    """A step that synchronises cannot be captured: the constructor
    raises, and never falls back to running the step eagerly."""
    x = torch.ones(4, device=card)

    def step():
        return x * float(x.sum().item())

    with pytest.raises(RuntimeError):
        StepGraph(step, card)
    torch.cuda.synchronize()
    assert float((x + 1).sum().item()) == 8.0


@pytest.mark.gpu
def test_serve_client_replays_from_its_loop_thread_on_card(card):
    """The client's loop thread replays the graphs the constructing
    thread captured; its streams equal ``engine.run()``'s tokens."""
    cfg, params = _card_model(card)
    kw = dict(device=card, max_batch=3, page_size=16, max_seq_len=128)
    prompts = _prompts(8, cfg.vocab_size, (40, 17, 90))
    eng = ServeEngine(cfg, params, **kw)
    reqs = [Request(p, 16) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    eng.shutdown()
    with ServeClient(cfg, params, **kw) as client:
        streams = [client.generate(p, max_tokens=16) for p in prompts]
        got = [list(s) for s in streams]
    for p, r, g in zip(prompts, reqs, got):
        n = _tie_free(cfg, params, p, np.asarray(r.tokens))
        assert g[:n] == r.tokens[:n]


@pytest.mark.gpu
@pytest.mark.parametrize("speculate", [0, 3])
def test_unfused_step_graph_equals_the_eager_step_on_card(card, speculate):
    """``fused=False``: a replay of the captured unfused decode (or verify)
    step gives the eager step's outputs and pool on the same inputs, with
    the paged kernel once a layer (the dense decode reading the gathered
    pages in place) and no host sync (sync debug mode "error" around the
    replay and a whole serve); the served tokens are greedy's up to the
    first near tie."""
    cfg, params = _card_model(card)
    eng = ServeEngine(cfg, params, device=card, max_batch=4, page_size=16,
                      max_seq_len=128, speculate=speculate, fused=False)
    graph = eng._verify_graph if speculate else eng._decode_graph
    assert graph.graph is not None and not eng.fused
    assert dict((m.__name__, n) for m, n in graph.launches) == {
        paged_attention.__name__: cfg.n_layers,
        rmsnorm.__name__: 2 * cfg.n_layers + 1}
    # a live-looking step on the static buffers: four slots at mixed
    # positions over disjoint pages, drafts and write tables for verify
    S, T, null = eng.max_batch, eng._table_pages, eng.pool.null_page
    gen = torch.Generator(device=card).manual_seed(0)
    for t in eng.pool.arrays.values():
        t.normal_(generator=gen)
    pos = torch.tensor([3, 40, 77, 120], dtype=torch.int32)
    pages = torch.randperm(eng.pool.total_pages)[:S * eng.max_pages]
    tables = torch.full((S, T), null, dtype=torch.int32)
    tables[:, :eng.max_pages] = pages.view(S, -1).to(torch.int32)
    eng._tables_dev.copy_(tables)
    eng._tokens.copy_(torch.randint(0, cfg.vocab_size, (S, 1, 1),
                                    generator=gen, device=card))
    meta = torch.zeros(eng._meta.shape[0], dtype=torch.int32)
    meta[:S] = pos
    meta[S:2 * S] = 1 + speculate
    if speculate:
        K, W = speculate, eng._verify_pages
        meta[2 * S:2 * S + S * K] = torch.randint(0, cfg.vocab_size, (S * K,))
        for s in range(S):
            meta[2 * S + S * K + s * W:2 * S + S * K + (s + 1) * W] = \
                torch.from_numpy(eng.pool.write_table(
                    tables[s].tolist(), int(pos[s]), W))
    eng._meta.copy_(meta.to(card))
    start = [t.clone() for t in (eng._tokens, *eng.pool.arrays.values())]

    def run(fn):
        for t, t0 in zip((eng._tokens, *eng.pool.arrays.values()), start):
            t.copy_(t0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
            out = [o.clone() for o in (out if speculate else (out,))]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, [t[:, :null].clone() for t in eng.pool.arrays.values()]

    replayed, replay_pool = run(graph)
    eager, eager_pool = run(graph.fn)
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)
    for a, b, t0 in zip(replay_pool, eager_pool, start[1:]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        assert not torch.equal(a, t0[:, :null])
    # then a serve from a clean pool, under sync debug mode "error"
    eng.shutdown()
    eng = ServeEngine(cfg, params, device=card, max_batch=4, page_size=16,
                      max_seq_len=128, speculate=speculate, fused=False)
    graph = eng._verify_graph if speculate else eng._decode_graph
    prompts = [np.tile(np.array([101, 7, 3000, 7]), 10)] + _prompts(
        9, cfg.vocab_size, (33, 70))
    reqs = [Request(p, 24) for p in prompts]
    paged_attention.LAUNCHES = 0
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.run(timeout=120)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert graph.replays == eng.stats["steps"] > 0
    assert paged_attention.LAUNCHES == cfg.n_layers * (
        eng.stats["steps"] + eng.stats["suffix_steps"])
    assert eng.metrics()["pages_in_use"] == 0
    for p, r in zip(prompts, reqs):
        want = greedy_generate(cfg, params, p[None], 24, 128,
                               device=card)[0].tolist()
        n = _tie_free(cfg, params, p, np.asarray(want))
        assert r.tokens[:n] == want[:n]
    eng.shutdown()

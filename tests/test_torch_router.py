"""The multi-replica front door in the port (``serve/router.py``) on the
CPU: prefix-affinity routing (hit rate on a shared-prefix trace,
saturation fallback), weighted per-tenant fairness (DRR share
convergence, quota refusal with retry-after), and heartbeat-driven
failover (kill a replica mid-decode: zero requests lost, the oracles'
tokens) — with page-leak checks on every replica's pool, the dead one's
included.

The scenarios are those of ``tests/serve/test_router.py``. Routing-policy
edges run against a stub tier satisfying ``EngineLike``; token identity
and failover run against real ``ServeEngine`` (and ``DisaggServer``)
replicas of reduced ``paper_demo`` in float32, held against the port's
own single engine and ``greedy_generate`` up to the first near tie (top-2
logit margin < 1e-3). The tests marked ``gpu`` run two replicas on the
card and skip elsewhere:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_router.py
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.core import Engine
from repro_torch.kernels import paged_attention
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (DisaggServer, EngineLike, FairBatcher,
                               GenerationConfig, QuotaExceeded, Request,
                               RequestState, Router, ServeClient,
                               ServeMetrics, greedy_generate,
                               serve_requests)
from repro_torch.serve.kv_cache import prefix_keys

MARGIN = 1e-3      # top-2 logit gap below which greedy tokens may flip
KW = dict(device="cpu", max_batch=2, max_cache_len=64, paged=True,
          page_size=4, max_seq_len=48)

PROMPTS = [
    list(range(1, 12)),
    list(range(5, 14)),
    [2, 3, 4, 5, 6],
    list(range(7, 20)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_model():
    jcfg = jax_get_config("paper_demo", reduced=True, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    cfg = get_config("paper_demo", reduced=True, dtype=torch.float32,
                     param_dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return cfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, "cpu")


def _tie_free(cfg, params, prompt, tokens):
    """Leading generated positions before the first near tie of the
    sequence ``prompt + tokens`` (teacher-forced, the port's forward)."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens)])
    dev = params["embed"]["tokens"].device
    logits = lm.lm_forward(params, {"tokens": torch.as_tensor(
        seq[None], dtype=torch.int32, device=dev)}, cfg)[0].float()
    steps = logits[len(prompt) - 1:len(prompt) - 1 + len(tokens)]
    top2 = torch.topk(steps, 2, dim=-1).values
    small = ((top2[:, 0] - top2[:, 1]) < MARGIN).nonzero()
    return len(tokens) if len(small) == 0 else int(small[0, 0])


def _assert_oracles(cfg, params, prompts, got, n=8, kw=KW):
    """``got[i]`` (token lists) equal a single engine's and
    ``greedy_generate``'s up to the oracle's first near tie; at least half
    of all tokens were compared."""
    single = serve_requests(cfg, params, [Request(p, n) for p in prompts],
                            timeout=300, **kw)
    dev = params["embed"]["tokens"].device
    checked = 0
    for p, g, s in zip(prompts, got, single):
        want = greedy_generate(cfg, params, np.asarray(p)[None], n, 64,
                               device=dev)[0].tolist()
        k = _tie_free(cfg, params, p, want)
        assert g[:k] == s.tokens[:k] == want[:k], (p, g, s.tokens, want)
        checked += k
    assert checked >= len(prompts) * n // 2


def _assert_no_leaks(router):
    for w in router.workers:
        if w.pool is not None:
            assert w.pool.pages_in_use == 0, \
                f"replica {w.rank} leaked {w.pool.pages_in_use} pages"


# ------------------------------------------------------------- stub tier
class _StubPool:
    """Just enough PagePool surface for the router's gossip/affinity."""

    total_pages = 256
    pages_in_use = 0
    page_size = 4

    def __init__(self):
        self.digests = set()

    def prefix_digests(self):
        return frozenset(self.digests)


class _StubTier:
    """An ``EngineLike`` tier with instant deterministic 'generation':
    token i for a prompt is ``sum(prompt) + i`` — same on every replica,
    so failover replay identity is checkable without a model."""

    paged = True
    page_size = 4
    max_seq_len = 10_000
    max_batch = 4

    def __init__(self, engine, tokens_per_step=2):
        self.engine = engine
        self.pool = _StubPool()
        self.active = []
        self.retired = []
        self._tps = tokens_per_step
        # the router only reads .batcher on ITSELF; tiers expose theirs
        # for the protocol, a stub object is enough
        self.batcher = type("B", (), {"closed": True, "drained": True})()

    def submit(self, request):
        request.on_admitted()
        self.active.append(request)
        base = sum(int(t) for t in request.prompt)
        for k in prefix_keys(request.prompt, self.page_size):
            self.pool.digests.add(k)
        request._stub_base = base
        return request

    def close_intake(self):
        pass

    def step(self):
        progressed = False
        for req in list(self.active):
            if req.is_terminal:
                self.active.remove(req)
                continue
            req.on_first_token()
            done = req.delivered
            n = min(self._tps, req.max_new_tokens - done)
            if n > 0:
                req.deliver([req._stub_base + done + i for i in range(n)])
                progressed = True
            if req.delivered >= req.max_new_tokens:
                req.retire()
                self.active.remove(req)
                self.retired.append(req)
        return progressed

    def run(self, timeout=None, idle_sleep=5e-5, until=None):
        while self.active:
            self.step()
        return self.retired

    def metrics(self):
        return ServeMetrics.from_flat({"finished": len(self.retired)})

    @property
    def idle(self):
        return not self.active

    def shutdown(self):
        pass


def _stub_router(n=2, **kw):
    engine = Engine()
    replicas = [_StubTier(engine) for _ in range(n)]
    return Router(replicas=replicas, engine=engine, **kw)


def _expected_stub_tokens(prompt, n):
    base = sum(prompt)
    return [base + i for i in range(n)]


# ------------------------------------------------------ policy (stub) tests
def test_stub_tier_satisfies_protocol():
    assert isinstance(_StubTier(Engine()), EngineLike)


def test_router_basic_stub_roundtrip():
    r = _stub_router(2)
    reqs = [r.submit(Request([i, i + 1], 4)) for i in range(4)]
    r.close_intake()
    done = r.run(timeout=30)
    assert len(done) == 4
    for req in reqs:
        assert req.tokens == _expected_stub_tokens(req.prompt, 4)
    m = r.metrics()
    assert m["routed"] == 4
    assert m["replicas_live"] == 2
    r.shutdown()


def test_affinity_prefers_digest_holder():
    r = _stub_router(2)
    prompt = list(range(1, 10))
    # replica 2 already holds this prompt's pages; 1 holds nothing
    r._digests[2] = set(prefix_keys(prompt, 4))
    req = r.submit(Request(prompt, 2))
    r.run(timeout=30, until=lambda: req.is_terminal and r.idle)
    assert r.metrics()["affinity_hits"] == 1
    assert r._rank_inflight[2] == 0 and r.stats["routed"] == 1
    # the dispatch went to rank 2 (its digest set absorbed the insert;
    # rank 1's is untouched)
    assert not r._digests[1]
    r.shutdown()


def test_affinity_falls_back_when_affine_replica_saturated():
    r = _stub_router(2, saturation=1)
    prompt = list(range(1, 10))
    r._digests[2] = set(prefix_keys(prompt, 4))
    # freeze dispatch-side capacity at rank 2
    r._rank_inflight[2] = 1
    req = r.submit(Request(prompt, 2))
    r.run(timeout=30, until=lambda: req.is_terminal and r.idle)
    m = r.metrics()
    assert m["affinity_misses"] == 1 and m["affinity_hits"] == 0
    # work landed on the unsaturated replica
    assert r.workers[0].tier.retired and not r.workers[1].tier.retired
    r._rank_inflight[2] = 0
    r.shutdown()


def test_quota_refusal_and_release():
    r = _stub_router(2, quota={"acme": 2})
    a = r.submit(Request([1, 2, 3], 4, ))
    acme = GenerationConfig(max_tokens=4, tenant="acme")
    b = r.submit(Request([1, 2, 4], acme))
    c = r.submit(Request([1, 2, 5], acme))
    with pytest.raises(QuotaExceeded) as ei:
        r.submit(Request([1, 2, 6], acme))
    assert ei.value.tenant == "acme"
    assert ei.value.retry_after_s >= 0.0
    assert r.metrics()["quota_refused"] == 1
    # default tenant is unlimited here
    r.submit(Request([9, 9], 4))
    # once acme's outstanding work completes, the quota slot frees up
    r.run(timeout=30, until=lambda: r.idle)
    d = r.submit(Request([1, 2, 7], acme))
    r.close_intake()
    done = r.run(timeout=30)
    assert d in done and len(done) == 5
    r.shutdown()


def test_weighted_share_convergence_fairbatcher():
    """DRR: with weights 3:1 and identical costs, admitted token budget
    converges to the weight ratio (checked over a prefix of the pops)."""
    engine = Engine()
    fb = FairBatcher(engine, weights={"gold": 3.0, "bronze": 1.0},
                     quantum=8.0)
    for i in range(40):
        fb.submit(Request([i], GenerationConfig(max_tokens=8,
                                                tenant="gold")))
        fb.submit(Request([i], GenerationConfig(max_tokens=8,
                                                tenant="bronze")))
    popped = fb.admit(40)
    assert len(popped) == 40
    gold = sum(1 for r in popped if r.tenant == "gold")
    bronze = len(popped) - gold
    assert bronze > 0
    assert 2.0 <= gold / bronze <= 4.0, (gold, bronze)
    # strict priority classes still dominate fairness
    hi = fb.submit(Request([99], GenerationConfig(max_tokens=8,
                                                  tenant="bronze",
                                                  priority=5)))
    assert fb.admit(1) == [hi]
    engine.shutdown()


def test_requeue_on_death_token_identity_stub():
    """Kill a stub replica mid-generation: every request finishes with
    the exact token sequence an uninterrupted run produces."""
    r = _stub_router(2, heartbeat_timeout_s=0.05, sweep_interval_s=0.01)
    reqs = [r.submit(Request([10 + i, 20 + i], 16)) for i in range(6)]
    r.close_intake()
    # step until some replica is mid-generation, then kill it
    deadline = time.monotonic() + 10
    victim = None
    while victim is None and time.monotonic() < deadline:
        r.step()
        for t in r._tracked.values():
            if t.rank is not None and 0 < t.original.delivered < 16:
                victim = t.rank
                break
    assert victim is not None
    r.kill_replica(victim)
    done = r.run(timeout=30)
    assert len(done) == 6          # zero requests lost
    for req in reqs:
        assert req.req_state is RequestState.FINISHED
        assert req.tokens == _expected_stub_tokens(req.prompt, 16)
    m = r.metrics()
    assert m["failovers"] == 1
    assert m["replicas_live"] == 1
    assert m["requeued"] >= 1
    r.shutdown()


def test_metrics_shape():
    r = _stub_router(2)
    req = r.submit(Request([1, 2], 4))
    r.close_intake()
    r.run(timeout=30)
    m = r.metrics()
    assert isinstance(m, ServeMetrics)
    assert m.finished == 1
    assert set(m["per_replica"]) == {1, 2}
    assert m["transport"]["sends"] >= 1
    assert 0.0 <= m["affinity_hit_rate"] <= 1.0
    assert req.tokens
    r.shutdown()


# ------------------------------------------------------- real-model tests
def test_router_matches_single_engine_greedy(small_model):
    cfg, params = small_model
    r = Router(cfg, params, n_replicas=2, **KW)
    reqs = [r.submit(Request(p, 8)) for p in PROMPTS]
    r.close_intake()
    done = r.run(timeout=300)
    assert len(done) == len(PROMPTS)
    per_replica = r.metrics()["per_replica"]
    assert all(per_replica[w.rank]["finished"] > 0 for w in r.workers)
    _assert_no_leaks(r)
    r.shutdown()
    _assert_oracles(cfg, params, PROMPTS, [q.tokens for q in reqs])


def test_affinity_hit_rate_on_shared_prefix_trace(small_model):
    cfg, params = small_model
    r = Router(cfg, params, n_replicas=2, **KW)
    shared = list(range(1, 9))             # two full pages @ page_size=4
    prompts = [shared + [30 + i] for i in range(12)]
    reqs = [r.submit(Request(p, 6)) for p in prompts]
    r.close_intake()
    done = r.run(timeout=300)
    assert len(done) == len(reqs)
    m = r.metrics()
    assert m["affinity_hit_rate"] > 0.8, m["affinity_hit_rate"]
    # affinity concentrated the prefix on one replica: its pool reused it
    reused = sum(w.pool.stats["prefix_tokens_reused"] for w in r.workers)
    assert reused > 0
    _assert_no_leaks(r)
    r.shutdown()
    _assert_oracles(cfg, params, prompts, [q.tokens for q in reqs], n=6)


def test_kill_replica_mid_decode_zero_loss(small_model):
    """Killing a replica mid-decode loses zero requests, every token
    stream is the oracles', and the dead replica's pool drains."""
    cfg, params = small_model
    r = Router(cfg, params, n_replicas=2, heartbeat_timeout_s=0.1,
               sweep_interval_s=0.01, **KW)
    reqs = [r.submit(Request(p, 8)) for p in PROMPTS]
    r.close_intake()
    deadline = time.monotonic() + 240
    victim = None
    while victim is None:
        assert time.monotonic() < deadline, "no decode progress"
        r.step()
        for t in r._tracked.values():
            if t.rank is not None and t.original.delivered >= 2:
                victim = t.rank
                break
    r.kill_replica(victim)
    done = r.run(timeout=300)
    assert len(done) == len(PROMPTS)       # zero requests lost
    m = r.metrics()
    assert m["failovers"] >= 1 and m["requeued"] >= 1
    # detected by the heartbeat sweep, one silence timeout after the last
    # beat (the kill came after it)
    assert len(r.failover_s) == 1 and 0.0 < r.failover_s[0] < 5.0
    _assert_no_leaks(r)                    # including the dead replica
    r.shutdown()
    _assert_oracles(cfg, params, PROMPTS, [q.tokens for q in reqs])


def test_router_over_disagg_replicas(small_model):
    """Replicas may be any ``EngineLike`` tier: two ``DisaggServer``s
    behind the router serve the oracles' tokens, and the router reads
    each one's limits and pool through its decode role."""
    cfg, params = small_model
    engine = Engine()
    kw = {k: v for k, v in KW.items() if k != "paged"}
    tiers = [DisaggServer(cfg, params, engine=engine, **kw)
             for _ in range(2)]
    r = Router(replicas=tiers, engine=engine)
    assert [w.pool for w in r.workers] == [t.decode.pool for t in tiers]
    reqs = [r.submit(Request(p, 8)) for p in PROMPTS]
    r.close_intake()
    assert len(r.run(timeout=300)) == len(PROMPTS)
    _assert_no_leaks(r)
    assert all(t.prefill.pool.pages_in_use == 0 for t in tiers)
    r.shutdown()
    engine.shutdown()
    _assert_oracles(cfg, params, PROMPTS, [q.tokens for q in reqs])


def test_serve_client_over_router(small_model):
    cfg, params = small_model
    r = Router(cfg, params, n_replicas=2, **KW)
    with ServeClient(engine=r) as client:
        streams = [client.generate(p, max_tokens=8) for p in PROMPTS]
        got = [list(s) for s in streams]
    _assert_no_leaks(r)
    _assert_oracles(cfg, params, PROMPTS, got)


def test_no_card_means_no_router(small_model):
    """The replicas' default device is the card: without one,
    construction raises (nothing falls back to the CPU)."""
    cfg, params = small_model
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Router(cfg, params, n_replicas=2)


# --------------------------------------------------------------- the card
@pytest.mark.gpu
def test_router_on_card_kill_replica_matches_greedy():
    """Two replicas on one card, replica killed mid-decode: zero loss,
    greedy's tokens, both pools drained, the paged kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        get_config("paper_demo", dtype=torch.float32,
                   param_dtype=torch.float32), n_layers=2)
    params = lm.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (40, 71, 17, 96)]
    r = Router(cfg, params, n_replicas=2, heartbeat_timeout_s=0.25,
               sweep_interval_s=0.02, max_batch=4, page_size=16,
               max_seq_len=256)
    paged_attention.LAUNCHES = 0
    reqs = [r.submit(Request(p, 24)) for p in prompts]
    r.close_intake()
    deadline = time.monotonic() + 120
    victim = None
    while victim is None:
        assert time.monotonic() < deadline, "no decode progress"
        r.step()
        for t in r._tracked.values():
            if t.rank is not None and t.original.delivered >= 4:
                victim = t.rank
                break
    r.kill_replica(victim)
    assert len(r.run(timeout=120)) == len(prompts)
    assert r.metrics()["failovers"] == 1 and paged_attention.LAUNCHES > 0
    _assert_no_leaks(r)
    r.shutdown()
    for p, q in zip(prompts, reqs):
        want = greedy_generate(cfg, params, p[None], 24, 256,
                               device="cuda")[0].tolist()
        n = _tie_free(cfg, params, p, want)
        assert q.tokens[:n] == want[:n]

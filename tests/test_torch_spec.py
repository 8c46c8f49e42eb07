"""Speculative decoding in the port against the JAX package on the CPU:
the drafters, the fused paged verify step, and the speculative engine's
token identity with both ``greedy_generate`` oracles (float32, reduced
``paper_demo``, the JAX package's own weights carried over)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serve import drafter as jdrafter
from repro.serve import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (GenerationConfig, NgramDrafter,
                               RepeatDrafter, Request, RequestState,
                               ServeEngine, greedy_generate,
                               make_fused_paged_verify_step)

ATOL = 1e-4        # float32 logits, as in the model parity tests
MARGIN = 1e-3      # top-2 logit gap below which greedy tokens may flip


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("paper_demo", reduced=True, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    tcfg = get_config("paper_demo", reduced=True, dtype=torch.float32,
                      param_dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------- drafters
@pytest.mark.parametrize("seed,vocab,max_ngram,min_ngram", [
    (0, 4, 3, 1), (1, 6, 3, 1), (2, 3, 2, 2), (3, 50, 3, 1), (4, 5, 4, 2)])
def test_drafters_match_reference(seed, vocab, max_ngram, min_ngram):
    rng = np.random.default_rng(seed)
    ours = NgramDrafter(max_ngram, min_ngram)
    theirs = jdrafter.NgramDrafter(max_ngram, min_ngram)
    proposed = 0
    for n in (0, 1, 2, 5, 17, 40):
        ctx = rng.integers(0, vocab, n).tolist()
        for k in (0, 1, 3, 6):
            got = ours.draft(ctx, k)
            assert got == theirs.draft(ctx, k)
            assert RepeatDrafter().draft(ctx, k) == \
                jdrafter.RepeatDrafter().draft(ctx, k)
            proposed += len(got)
    assert proposed > 0
    for bad in ((0, 1), (2, 3)):
        with pytest.raises(ValueError):
            NgramDrafter(*bad)


# ------------------------------------------------------------ verify step
def _pool_case(tcfg, seed, positions, W, ps=8, T=6):
    """A random layer-stacked pool and disjoint, null-padded tables."""
    rng = np.random.default_rng(seed)
    S = len(positions)
    n_real = S * T
    shape = (tcfg.n_layers, n_real + 1, ps, tcfg.padded_kv_heads,
             tcfg.resolved_head_dim)
    pool = {k: (0.5 * rng.normal(size=shape)).astype(np.float32)
            for k in ("k", "v")}
    tables = np.full((S, T), n_real, np.int32)
    perm = rng.permutation(n_real)
    for s in range(S):
        need = -(-(positions[s] + W) // ps)
        tables[s, :need] = perm[s * T:s * T + need]
    return pool, tables, n_real


@pytest.mark.parametrize("K,positions,n_valid,matched", [
    # idle slot, no drafts, drafts partly / fully / not matched
    (3, [5, 17, 30, 8, 22], [0, 1, 4, 3, 4], [0, 0, 2, 2, 0]),
    # windows straddling a page boundary, every slot live
    (2, [7, 15, 0], [3, 3, 2], [1, 2, 1]),
])
def test_verify_step_matches_jax(model, K, positions, n_valid, matched):
    """``emitted`` and ``accepts`` equal; logits within ATOL; pools equal
    on real pages: rows nobody wrote bit for bit, written rows within
    ATOL (the port writes nothing past ``n_valid``; the JAX reference
    parks those rows on the null page, which is excluded)."""
    jcfg, tcfg, jp, tp = model
    ps, W = 8, 1 + K
    pool, tables, null = _pool_case(tcfg, 11, positions, W, ps)
    S = len(positions)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, tcfg.vocab_size, (S, 1, W)).astype(np.int32)
    jstep = jax.jit(jsteps.make_fused_paged_verify_step(jcfg, ps, K))
    jpos = jnp.asarray(positions, jnp.int32)
    jnv = jnp.asarray(n_valid, jnp.int32)

    def jax_run(toks):
        return jstep(jp, {k: jnp.asarray(v) for k, v in pool.items()},
                     jnp.asarray(toks), jpos, jnp.asarray(tables), jnv)

    # drafts chosen one window row at a time, so that each slot's first
    # ``matched`` drafts equal the model's own tokens and the next differs
    for j in range(K):
        emitted = np.asarray(jax_run(tokens)[0])
        for s in range(S):
            if j < matched[s]:
                tokens[s, 0, 1 + j] = emitted[s, j]
            elif j == matched[s]:
                tokens[s, 0, 1 + j] = (emitted[s, j] + 1) % tcfg.vocab_size
    j_emitted, j_accepts, j_pool = jax_run(tokens)
    np.testing.assert_array_equal(np.asarray(j_accepts), matched)

    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    t_args = (torch.from_numpy(tokens), torch.tensor(positions,
                                                     dtype=torch.int32),
              torch.from_numpy(tables), torch.tensor(n_valid,
                                                     dtype=torch.int32))
    step = make_fused_paged_verify_step(tcfg, ps, K)
    emitted, accepts, tpool = step(tp, tpool, *t_args)
    assert emitted.dtype == accepts.dtype == torch.int32
    assert tuple(emitted.shape) == (S, W) and tuple(accepts.shape) == (S,)
    live = np.asarray(n_valid) > 0
    np.testing.assert_array_equal(emitted.numpy()[live],
                                  np.asarray(j_emitted)[live])
    np.testing.assert_array_equal(accepts.numpy(), np.asarray(j_accepts))
    # rows the window did not write (every row past n_valid included) are
    # the input's, bit for bit; written rows agree within ATOL (the K/V
    # of a later layer carry the float32 rounding of the layers before)
    written = np.zeros(pool["k"].shape[1:3], bool)          # (pages, ps)
    for s in range(S):
        for j in range(n_valid[s]):
            pos = positions[s] + j
            written[tables[s, pos // ps], pos % ps] = True
    written = written[:null]
    for name in ("k", "v"):
        ours = tpool[name][:, :null].numpy()
        theirs = np.asarray(j_pool[name])[:, :null]
        np.testing.assert_array_equal(ours[:, ~written],
                                      pool[name][:, :null][:, ~written])
        np.testing.assert_array_equal(theirs[:, ~written],
                                      pool[name][:, :null][:, ~written])
        np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)

    # the window's logits, through the forward both steps share
    tl, _ = lm.lm_paged_decode(
        tp, t_args[0][:, 0], tcfg,
        {k: torch.from_numpy(v.copy()) for k, v in pool.items()},
        *t_args[1:], page_size=ps)
    jl, _ = jlm.lm_paged_decode(
        jp, jnp.asarray(tokens[:, 0]), jcfg,
        {k: jnp.asarray(v) for k, v in pool.items()}, jpos,
        jnp.asarray(tables), jnv, page_size=ps)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL, rtol=0)


# ------------------------------------------------------ speculative engine
def _near_tie_prefix(jcfg, jp, prompt, tokens):
    """Generated positions before the first whose JAX top-2 logit margin
    (teacher-forced over the sequence) is below MARGIN."""
    seq = np.concatenate([prompt, tokens]).astype(np.int32)
    logits = np.asarray(jlm.lm_forward(jp, {"tokens": jnp.asarray(seq[None])},
                                       jcfg))[0]
    steps = logits[len(prompt) - 1:len(prompt) - 1 + len(tokens)]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    small = np.nonzero(top2[:, 1] - top2[:, 0] < MARGIN)[0]
    return len(tokens) if len(small) == 0 else int(small[0])


def _workload(kind):
    """(prompts, token budgets, per-request speculate caps)."""
    rng = np.random.default_rng(21)
    if kind == "random":
        prompts = [rng.integers(0, 512, n) for n in (12, 9, 20)]
        return prompts, [9, 14, 23], [None] * 3
    motif = np.array([5, 11, 3, 7])
    if kind == "repetitive":
        prompts = [np.tile(np.roll(motif, i % 4), 4) for i in range(3)]
        return prompts, [20, 16, 24], [None] * 3
    # more requests than slots, a mix of repetitive and random prompts,
    # of request-level caps (0 never drafts) and of budgets
    prompts = [np.tile(np.roll(motif, i), 3 + i) for i in range(4)] + [
        rng.integers(0, 512, n) for n in (7, 15, 26)]
    return prompts, [12, 5, 18, 9, 2, 16, 11], [None, 0, 1, None, 2, None, 3]


@pytest.mark.parametrize("kind", ["random", "repetitive", "oversubscribed"])
def test_spec_engine_matches_both_greedy_oracles(model, kind):
    jcfg, tcfg, jp, tp = model
    prompts, budgets, caps = _workload(kind)
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=3, page_size=8,
                      max_seq_len=64, speculate=3)
    reqs = [Request(p, GenerationConfig(max_tokens=n, speculate=c))
            for p, n, c in zip(prompts, budgets, caps)]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    m = eng.metrics()
    assert m["pages_in_use"] == 0 and eng.idle
    assert m["verify_steps"] == eng.stats["steps"] > 0
    assert m["speculate"] == 3
    if kind == "repetitive":
        assert m["draft_accepted"] > 0
        assert m["spec_tokens"] > m["verify_steps"]   # runs of 2+ tokens
    checked = 0
    for p, n, r in zip(prompts, budgets, reqs):
        assert r.req_state is RequestState.FINISHED and len(r.tokens) == n
        ours = greedy_generate(tcfg, tp, p[None], n, 64,
                               device="cpu")[0].tolist()
        theirs = np.asarray(jsteps.greedy_generate(
            jcfg, jp, jnp.asarray(p[None], jnp.int32), n, 64))[0]
        k = _near_tie_prefix(jcfg, jp, p, theirs)
        assert r.tokens[:k] == ours[:k] == theirs[:k].tolist()
        checked += k
    assert checked >= sum(budgets) // 2


def test_cancel_mid_verify_leaks_no_pages(model):
    """A request cancelled while its verify step is in flight gets none of
    that step's tokens, its slot and pages are freed, and the others
    finish with greedy's tokens."""
    _, tcfg, _, tp = model
    prompts, budgets, _ = _workload("repetitive")
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=3, page_size=8,
                      max_seq_len=64, speculate=3)
    reqs = [Request(p, n) for p, n in zip(prompts, budgets)]
    victim = reqs[1]
    replay = eng._verify_graph
    at_cancel = []

    def verify_then_cancel():
        out = replay()
        if not at_cancel and victim.delivered >= 2:
            at_cancel.append(victim.delivered)
            assert victim.cancel()
        return out

    eng._verify_graph = verify_then_cancel
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    assert at_cancel, "the victim never reached a verify step"
    assert victim.req_state is RequestState.CANCELLED
    assert victim.delivered == at_cancel[0]
    assert eng.metrics()["pages_in_use"] == 0
    assert eng.active == 0 and not eng._verifying and eng.idle
    for p, n, r in zip(prompts, budgets, reqs):
        if r is not victim:
            assert r.req_state is RequestState.FINISHED
            assert r.tokens == greedy_generate(tcfg, tp, p[None], n, 64,
                                               device="cpu")[0].tolist()

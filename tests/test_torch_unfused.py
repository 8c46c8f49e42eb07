"""The port's unfused paged serving against the JAX package on the CPU:
``make_paged_{decode,verify,suffix}_step`` step by step against the JAX
factories (logits and pool), ``PagePool.write_table``, and the
``fused=False`` engine's tokens against the JAX ``greedy_generate``, with
and without speculation (float32, reduced ``paper_demo``, the JAX
package's own weights carried over)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.serve import kv_cache as jkv
from repro.serve import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (PagePool, Request, RequestState, ServeEngine,
                               make_paged_decode_step, make_paged_suffix_step,
                               make_paged_verify_step)

ATOL = 1e-5        # float32 logits and pools, the same dense decode
MARGIN = 1e-3      # top-2 logit gap below which greedy tokens may flip
PS = 8


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


def _pool(tcfg, n_real, seed):
    rng = np.random.default_rng(seed)
    shape = (tcfg.n_layers, n_real + 1, PS, tcfg.padded_kv_heads,
             tcfg.resolved_head_dim)
    return {k: (0.5 * rng.normal(size=shape)).astype(np.float32)
            for k in ("k", "v")}


def _tables(positions, T, n_real, seed, reach=1):
    """Disjoint tables covering each live slot's ``pos + reach`` positions,
    null-padded; a slot at position -1 is idle (all null, position 0)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_real)
    tables = np.full((len(positions), T), n_real, np.int32)
    for s, pos in enumerate(positions):
        if pos >= 0:
            need = -(-(pos + reach) // PS)
            tables[s, :need] = perm[s * T:s * T + need]
    return tables, np.maximum(np.asarray(positions, np.int32), 0)


def _close_pools(ours, theirs, start, null, untouched):
    """Real pages within ATOL of the JAX step's; ``untouched`` (pages,
    rows) mask of rows no live slot wrote: bit-equal to ``start``."""
    for name in ("k", "v"):
        a = ours[name][:, :null].numpy()
        b = np.asarray(theirs[name])[:, :null]
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        s = start[name][:, :null]
        np.testing.assert_array_equal(a[:, untouched], s[:, untouched])


def test_decode_step_matches_jax_step_by_step(model):
    """Three unfused decode steps in a row, an idle slot among live ones
    (one at a page boundary): logits within ATOL, the same greedy tokens
    (``return_tokens``), the pools within ATOL after every step, and no
    real page row written but the live slots' own."""
    jcfg, tcfg, jp, tp = model
    positions, T, n_real = [5, -1, 15, 30], 6, 24
    tables, pos = _tables(positions, T, n_real, 1, reach=3)
    start = _pool(tcfg, n_real, 2)
    jstep = jax.jit(jsteps.make_paged_decode_step(jcfg, PS))
    logits_step = make_paged_decode_step(tcfg, PS)
    token_step = make_paged_decode_step(tcfg, PS, return_tokens=True)
    jpool = {k: jnp.asarray(v) for k, v in start.items()}
    tpool = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    twin = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (4, 1, 1)).astype(np.int32)
    written = np.zeros((n_real + 1, PS), bool)
    for _ in range(3):
        jl, jpool = jstep(jp, jpool, jnp.asarray(tokens), jnp.asarray(pos),
                          jnp.asarray(tables))
        args = (torch.from_numpy(tokens), torch.from_numpy(pos),
                torch.from_numpy(tables))
        tl, tpool = logits_step(tp, tpool, *args)
        nxt, twin = token_step(tp, twin, *args)
        assert tuple(tl.shape) == tuple(jl.shape)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        want = np.argmax(np.asarray(jl)[:, :, -1, :], axis=-1)
        assert nxt.dtype == torch.int32
        np.testing.assert_array_equal(nxt.numpy(), want)
        for s, p in enumerate(positions):
            if p >= 0:
                written[tables[s, pos[s] // PS], pos[s] % PS] = True
        _close_pools(tpool, jpool, start, n_real, ~written[:n_real])
        for name in tpool:
            assert torch.equal(tpool[name], twin[name])
        tokens = want.astype(np.int32)[:, :, None]
        pos = pos + (np.asarray(positions) >= 0)


@pytest.mark.parametrize("K,positions,n_drafts,matched", [
    # a slot with no drafts, an idle slot, drafts partly / fully matched,
    # the last slot's window past its footprint
    (3, [5, -1, 22, 13], [0, 0, 3, 3], [0, 0, 2, 3]),
    # windows across a page boundary
    (2, [7, 15, 0], [2, 2, 1], [1, 2, 0]),
])
def test_verify_step_matches_jax_step_by_step(model, K, positions, n_drafts,
                                              matched):
    """Two unfused verify steps in a row: ``emitted`` and ``accepts``
    equal, the pools within ATOL, write tables equal to the JAX pool's,
    and rows outside the live windows untouched."""
    jcfg, tcfg, jp, tp = model
    W = 1 + -(-K // PS)
    T, n_real = 6 + W - 1, 30
    tables, pos = _tables(positions, T, n_real, 4, reach=K + 1)
    # the last slot's footprint ends inside its window: the tail beyond it
    # must go to the scratch page
    last = len(positions) - 1
    tables[last, -(-(pos[last] + 1) // PS):] = n_real
    start = _pool(tcfg, n_real, 5)
    live = np.asarray(positions) >= 0
    tpools = PagePool(tcfg, n_real, PS, device="cpu")
    jpools = jkv.PagePool(jcfg, n_real, PS)
    n_drafts = np.asarray(n_drafts, np.int32)
    jstep = jax.jit(jsteps.make_paged_verify_step(jcfg, PS, K))
    step = make_paged_verify_step(tcfg, PS, K)
    jpool = {k: jnp.asarray(v) for k, v in start.items()}
    tpool = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, tcfg.vocab_size, (len(positions), 1, 1 + K)
                          ).astype(np.int32)
    written = np.zeros((n_real + 1, PS), bool)
    for _ in range(2):
        wt = np.full((len(positions), W), n_real, np.int32)
        for s in np.nonzero(live)[0]:
            ids = [int(i) for i in tables[s] if i != n_real]
            wt[s] = tpools.write_table(ids, int(pos[s]), W)
            np.testing.assert_array_equal(
                wt[s], jpools.write_table(ids, int(pos[s]), W))
            for j in range(1 + K):
                page = wt[s, (pos[s] % PS + j) // PS]
                written[page, (pos[s] + j) % PS] = True
        jargs = (jnp.asarray(pos), jnp.asarray(tables), jnp.asarray(wt),
                 jnp.asarray(n_drafts))
        # drafts chosen so that each slot's first ``matched`` equal the
        # model's own tokens and the next differs
        for j in range(K):
            em = np.asarray(jstep(jp, jpool, jnp.asarray(tokens), *jargs)[0])
            for s in range(len(positions)):
                if j < matched[s]:
                    tokens[s, 0, 1 + j] = em[s, j]
                elif j == matched[s]:
                    tokens[s, 0, 1 + j] = (em[s, j] + 1) % tcfg.vocab_size
        j_em, j_acc, jpool = jstep(jp, jpool, jnp.asarray(tokens), *jargs)
        em, acc, tpool = step(tp, tpool, torch.from_numpy(tokens),
                              torch.from_numpy(pos), torch.from_numpy(tables),
                              torch.from_numpy(wt),
                              torch.from_numpy(n_drafts))
        assert em.dtype == acc.dtype == torch.int32
        np.testing.assert_array_equal(em.numpy(), np.asarray(j_em))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
        np.testing.assert_array_equal(acc.numpy()[live],
                                      np.minimum(matched, n_drafts)[live])
        _close_pools(tpool, jpool, start, n_real, ~written[:n_real])
        adv = np.minimum(acc.numpy() + 1, 1 + K) * live
        tokens[:, 0, 0] = em.numpy()[np.arange(len(positions)), adv - 1]
        pos = pos + adv


def test_suffix_step_matches_jax(model):
    """A tail of 11 tokens after two shared pages, padded to two pages:
    logits within ATOL; the owned pages within ATOL; the shared pages and
    every page outside the request bit-equal to the input."""
    jcfg, tcfg, jp, tp = model
    n_real, T = 12, 6
    start = _pool(tcfg, n_real, 7)
    shared, owned = [3, 9], [0, 7, 5]
    gather = np.full(T, n_real, np.int32)
    gather[:5] = shared + owned
    scatter = np.full(T, n_real, np.int32)
    scatter[2:5] = owned
    tokens = np.zeros((1, 2 * PS), np.int32)
    tokens[0, :11] = np.random.default_rng(8).integers(0, tcfg.vocab_size, 11)
    jl, jpool = jax.jit(jsteps.make_paged_suffix_step(jcfg, PS))(
        jp, {k: jnp.asarray(v) for k, v in start.items()},
        jnp.asarray(tokens), jnp.int32(2 * PS), jnp.asarray(gather),
        jnp.asarray(scatter))
    tpool = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    tl, tpool = make_paged_suffix_step(tcfg, PS)(
        tp, tpool, torch.from_numpy(tokens), 2 * PS,
        torch.from_numpy(gather), torch.from_numpy(scatter))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    untouched = np.ones((n_real, PS), bool)
    untouched[owned] = False
    _close_pools(tpool, jpool, start, n_real, untouched)


# ------------------------------------------------------------ the engine
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


def _prompts():
    """Ragged prompts, three sharing a two-page prefix (suffix prefill),
    one a repeated motif (drafts accepted)."""
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 512, 2 * PS)
    return [prefix, rng.integers(0, 512, 17), np.tile([5, 11, 3, 7], 5)] + [
        np.concatenate([prefix, rng.integers(0, 512, n)]) for n in (3, 12)]


@pytest.mark.parametrize("speculate", [0, 3])
def test_unfused_engine_matches_jax_greedy(model, speculate):
    """``ServeEngine(fused=False)``: every request finishes with the JAX
    ``greedy_generate``'s tokens up to its first near tie, the suffix path
    runs, and the pool drains."""
    jcfg, tcfg, jp, tp = model
    prompts, n_new = _prompts(), 12
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=3, page_size=PS,
                      max_seq_len=64, fused=False, speculate=speculate)
    assert eng.paged and not eng.fused
    reqs = [Request(p, n_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    m = eng.metrics()
    assert m["pages_in_use"] == 0 and not m["fused"]
    assert eng.stats["suffix_steps"] > 0
    graph = eng._verify_graph if speculate else eng._decode_graph
    assert graph.replays == eng.stats["steps"] > 0
    if speculate:
        assert m["draft_accepted"] > 0
    checked = 0
    for p, r in zip(prompts, reqs):
        assert r.req_state is RequestState.FINISHED
        theirs = np.asarray(jsteps.greedy_generate(
            jcfg, jp, jnp.asarray(p[None], jnp.int32), n_new, 64))[0]
        n = _near_tie_prefix(jcfg, jp, p, theirs)
        assert r.tokens[:n] == theirs[:n].tolist()
        checked += n
    assert checked >= len(prompts) * n_new // 2

"""The port's serving path against the JAX package on the CPU: prefix
digests, page-pool bookkeeping, and float32 token identity of the port's
``ServeEngine`` (fused paged kernel path) with both ``greedy_generate``
oracles."""
import dataclasses

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
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (GenerationConfig, PagePool, Request,
                               RequestState, ServeEngine, greedy_generate,
                               prefix_keys)

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


def _prompts(seed=0, page=8):
    """Ragged prompts; three share a two-page prefix so the engine's
    suffix-prefill path runs."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 512, 2 * page)
    cold = [rng.integers(0, 512, n) for n in (5, 17, 33, 9)]
    warm = [np.concatenate([prefix, rng.integers(0, 512, n)])
            for n in (3, 9, 20)]
    return [prefix] + cold + warm


@pytest.mark.parametrize("page_size,n", [(4, 0), (8, None), (16, 2),
                                         (3, None)])
def test_prefix_keys_byte_identical(page_size, n):
    toks = np.random.default_rng(1).integers(0, 50000, 53)
    assert prefix_keys(toks, page_size, n) == \
        jkv.prefix_keys(toks, page_size, n)
    assert prefix_keys(list(toks), page_size, n) == \
        jkv.prefix_keys(list(toks), page_size, n)


def test_page_pool_bookkeeping_matches_jax(model):
    jcfg, tcfg, _, _ = model
    pools = [PagePool(tcfg, 12, 4, device="cpu"), jkv.PagePool(jcfg, 12, 4)]
    rng = np.random.default_rng(2)
    base = rng.integers(0, 512, 12)
    prompts = [base, np.concatenate([base, [1, 2, 3]]),
               rng.integers(0, 512, 9)]
    states = []
    for pool in pools:
        log = []
        held = []
        for p in prompts:
            shared = pool.match_prefix(p)
            owned = pool.alloc(4 - len(shared))
            for s in shared:
                pool.retain(s)
            table = shared + owned
            pool.register_prefix(p, table)
            held.append(table)
            log.append((shared, owned, pool.pages_in_use))
        log.append(pool.alloc(99))
        for table in held[:2]:
            pool.release(table)
        log.append((pool.pages_in_use, sorted(pool.prefix_digests()),
                    pool.resident_prefix_len(prompts[1])))
        m = pool.metrics()
        log.append({k: m[k] for k in ("allocated", "released",
                                      "peak_in_use", "pages_in_use",
                                      "total_pages", "page_size")})
        states.append(log)
    assert states[0] == states[1]


def _near_tie_prefix(jcfg, jp, prompt, tokens):
    """Generated positions before the first whose JAX top-2 logit margin
    (teacher-forced over the sequence) is below MARGIN; also returns
    those logits."""
    seq = np.concatenate([prompt, tokens]).astype(np.int32)
    logits = np.asarray(jlm.lm_forward(jp, {"tokens": jnp.asarray(seq[None])},
                                       jcfg))[0]
    steps = logits[len(prompt) - 1:len(prompt) - 1 + len(tokens)]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    small = np.nonzero(top2[:, 1] - top2[:, 0] < MARGIN)[0]
    return (len(tokens) if len(small) == 0 else int(small[0])), seq, logits


def test_engine_tokens_match_both_greedy_oracles(model):
    jcfg, tcfg, jp, tp = model
    prompts = _prompts()
    n_new = 10
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=3,
                      max_cache_len=96, page_size=8)
    reqs = [Request(p, n_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    m = eng.metrics()
    assert m["pages_in_use"] == 0 and m["prefix_hits"] > 0
    assert eng.stats["suffix_steps"] > 0
    checked = 0
    for p, r in zip(prompts, reqs):
        assert r.req_state is RequestState.FINISHED
        ours = greedy_generate(tcfg, tp, p[None], n_new, 96,
                               device="cpu")[0].tolist()
        theirs = np.asarray(jsteps.greedy_generate(
            jcfg, jp, jnp.asarray(p[None], jnp.int32), n_new, 96))[0]
        n, seq, jlogits = _near_tie_prefix(jcfg, jp, p, theirs)
        assert r.tokens[:n] == ours[:n] == theirs[:n].tolist()
        checked += n
        # logits throughout, on the JAX oracle's sequence
        tlogits = lm.lm_forward(tp, {"tokens": torch.from_numpy(seq[None])},
                                tcfg)[0].numpy()
        np.testing.assert_allclose(tlogits, jlogits, atol=1e-4, rtol=0)
    assert checked >= len(prompts) * n_new // 2


def test_single_token_and_stop_sequence_requests(model):
    _, tcfg, _, tp = model
    p = _prompts()[1]
    want = greedy_generate(tcfg, tp, p[None], 6, 64, device="cpu")[0]
    want = want.tolist()
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=2,
                      max_cache_len=64, page_size=8)
    one = Request(p, 1)
    stop = Request(p, GenerationConfig(max_tokens=6, stop=[want[2:4]]))
    for r in (one, stop):
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=60)
    assert one.tokens == want[:1]
    assert stop.tokens == want[:2]
    assert eng.metrics()["pages_in_use"] == 0


def test_cancel_before_admission_and_mid_decode_leak_nothing(model):
    _, tcfg, _, tp = model
    prompts = _prompts()
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=2,
                      max_cache_len=64, page_size=8)
    early = Request(prompts[1], 8)
    mid = Request(prompts[2], 30)
    rest = Request(prompts[3], 5)
    for r in (early, mid, rest):
        eng.submit(r)
    early.cancel()
    eng.close_intake()
    while mid.delivered < 3:
        eng.step()
    mid.cancel()
    eng.run(timeout=60)
    assert early.req_state is RequestState.CANCELLED
    assert mid.req_state is RequestState.CANCELLED
    assert rest.req_state is RequestState.FINISHED
    assert eng.metrics()["pages_in_use"] == 0


def test_capacity_deferral_serves_everything(model):
    """A pool too small for all requests at once defers admissions until
    retirements return pages."""
    _, tcfg, _, tp = model
    prompts = _prompts()[1:5]
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=4,
                      max_cache_len=64, page_size=8, total_pages=10)
    reqs = [Request(p, 12) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=60)
    assert all(r.req_state is RequestState.FINISHED for r in reqs)
    assert eng.stats["deferred"] > 0
    assert eng.metrics()["pages_in_use"] == 0


def test_unported_options_and_missing_cuda_raise(model):
    """``fused=False`` constructs the unfused paged engine, and fused steps
    without paging raise; dense mode for the dense family
    constructs, and refuses speculation as in the reference; paged
    ``speculate=2`` constructs, and on the SSM config (dense mode) it
    raises as in the reference; an SSM config constructs, in dense mode,
    and refuses the paged cache it has no use for; a sliding-window config
    takes dense mode by itself."""
    _, tcfg, _, tp = model
    eng = ServeEngine(tcfg, tp, device="cpu", fused=False)
    assert eng.paged and not eng.fused and not eng.metrics()["fused"]
    eng.shutdown()
    with pytest.raises(ValueError, match="require paged=True"):
        ServeEngine(tcfg, tp, device="cpu", paged=False, fused=True)
    eng = ServeEngine(tcfg, tp, device="cpu", paged=False)
    assert not eng.paged and eng.pool is None
    eng.shutdown()
    with pytest.raises(ValueError, match="speculate > 0 requires paged"):
        ServeEngine(tcfg, tp, device="cpu", paged=False, speculate=2)
    eng = ServeEngine(tcfg, tp, device="cpu", speculate=2)
    assert eng.paged and eng.speculate == 2
    eng.shutdown()
    scfg = get_config("mamba2_370m", reduced=True, dtype=torch.float32,
                      param_dtype=torch.float32)
    sp = lm.init_params(scfg, seed=0, device="cpu")
    eng = ServeEngine(scfg, sp, device="cpu")
    assert not eng.paged and not eng.fused and eng.pool is None
    eng.shutdown()
    with pytest.raises(ValueError, match="speculate > 0 requires paged"):
        ServeEngine(scfg, sp, device="cpu", speculate=2)
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        ServeEngine(scfg, sp, device="cpu", paged=True)
    with pytest.raises(NotImplementedError, match="audio enc-dec"):
        ServeEngine(dataclasses.replace(tcfg, family="audio"), tp,
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeEngine(tcfg, tp)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lm.init_params(tcfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            greedy_generate(tcfg, tp, [[1, 2, 3]], 2, 8)
    eng = ServeEngine(dataclasses.replace(tcfg, window=8), tp, device="cpu")
    assert not eng.paged and eng._cache["k"].shape[2] == 8
    eng.shutdown()
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        ServeEngine(dataclasses.replace(tcfg, window=8), tp, device="cpu",
                    paged=True)

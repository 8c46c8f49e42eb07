"""The port's Mamba-2 (SSM) path against the JAX package on the CPU:
``mamba2_370m`` reduced (2 layers, d_model 128, 16 SSD heads of head_dim
16, state 16, chunk 32) in float32 with the reference's weights carried
over (``models.convert.params_from_numpy``), model functions at atol
1e-4, and float32 token identity of the engine's dense (per-slot state)
mode with the JAX dense engine and both ``greedy_generate`` oracles.

Prompts are at least ``conv_width - 1`` = 3 tokens long wherever the JAX
package is the oracle: for shorter prompts the reference slices a conv
state of one row (``xs_raw[:, T - 3:]`` with a negative start), which its
dense engine then broadcasts over the slot's three. The port pads that
state with zeros, the padding the causal conv itself sees; a separate
test holds a 2-token prompt against the port's own full forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro.serve import request as jrequest
from repro.serve import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.models import lm, ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (Request, RequestState, ServeEngine,
                               greedy_generate, make_batched_decode_step)

ATOL = 1e-4
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
    jcfg = jax_get_config("mamba2_370m", reduced=True, dtype=jnp.float32,
                          param_dtype=jnp.float32)
    tcfg = get_config("mamba2_370m", reduced=True, dtype=torch.float32,
                      param_dtype=torch.float32)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    j = jax_get_config("mamba2_370m", reduced=reduced)
    t = get_config("mamba2-370m", reduced=reduced)
    for f in dataclasses.fields(jcommon.ModelConfig):
        if f.name not in ("dtype", "param_dtype", "ssm"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
    for prop in ("ssm_inner", "ssm_heads", "padded_vocab", "attn_free"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.param_count() == j.param_count()


def test_init_params_tree_dtypes_and_scales():
    jcfg = jax_get_config("mamba2_370m", reduced=True)
    tcfg = get_config("mamba2_370m", reduced=True)
    jp = jax.tree_util.tree_map(np.asarray,
                                jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tp = lm.init_params(tcfg, seed=3, device="cpu")
    jl, jtree = jax.tree_util.tree_flatten_with_path(jp)[0], \
        jax.tree_util.tree_structure(jp)
    assert jtree == jax.tree_util.tree_structure(tp)
    for (path, a), b in zip(jl, jax.tree_util.tree_leaves(tp)):
        name = jax.tree_util.keystr(path)
        assert tuple(b.shape) == a.shape, name
        want = torch.float32 if a.dtype == np.float32 else torch.bfloat16
        assert b.dtype == want, name
        bf = b.float()
        # same init scales (the draws differ: another generator)
        assert abs(float(bf.std()) - float(a.astype(np.float32).std())) \
            <= 0.15 * float(a.astype(np.float32).std()) + 1e-6, name
    for name in ("A_log", "D", "norm_scale"):
        np.testing.assert_allclose(tp["layers"]["ssm"][name].numpy(),
                                   jp["layers"]["ssm"][name], rtol=1e-6)
    again = lm.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(tp["layers"]["ssm"]["wx"],
                       again["layers"]["ssm"]["wx"])


def test_params_from_numpy_checks_the_ssm_stack(model):
    jcfg, tcfg, jp, _ = model
    tree = jax.tree_util.tree_map(np.asarray, jp)
    for name in ("A_log", "D", "dt_bias", "norm_scale"):
        assert params_from_numpy(tree, tcfg, "cpu")["layers"]["ssm"][
            name].dtype == torch.float32
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_numpy(tree, dataclasses.replace(tcfg, n_layers=3), "cpu")


# ------------------------------------------------------------------- block
@pytest.mark.parametrize("T", [37, 64, 5])
def test_ssm_block_both_branches_match_jax(model, T):
    jcfg, tcfg, jp, tp = model
    x = np.random.default_rng(T).normal(size=(2, T, 128)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["ssm"])
    tl = {k: v[0] for k, v in tp["layers"]["ssm"].items()}
    _close(ssm.ssm_block(tl, torch.from_numpy(x), tcfg),
           jssm.ssm_block(jl, jnp.asarray(x), jcfg))
    out, state = ssm.ssm_block(tl, torch.from_numpy(x), tcfg,
                               return_state=True)
    jout, jstate = jssm.ssm_block(jl, jnp.asarray(x), jcfg,
                                  return_state=True)
    _close(out, jout)
    assert set(state) == set(jstate)
    for name in state:
        assert state[name].dtype == (torch.float32 if name == "ssm"
                                     else tcfg.dtype)
        _close(state[name], jstate[name])


def test_ssm_decode_step_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(1)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["ssm"])
    tl = {k: v[1] for k, v in tp["layers"]["ssm"].items()}
    jstate = jssm.init_ssm_state(jcfg, 3)
    jstate = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
              for k, v in jstate.items()}
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    for i in range(3):
        x = rng.normal(size=(3, 1, 128)).astype(np.float32)
        jout, jstate = jssm.ssm_decode_step(jl, jnp.asarray(x), jcfg, jstate)
        tout, tstate = ssm.ssm_decode_step(tl, torch.from_numpy(x), tcfg,
                                           tstate)
        _close(tout, jout)
    for name in jstate:
        _close(tstate[name], jstate[name])


# ------------------------------------------------------------------- model
def test_lm_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens(3, (2, 41))
    _close(lm.lm_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg),
           jlm.lm_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg))


@pytest.mark.parametrize("T", [31, 67])
def test_lm_prefill_and_decode_match_jax(model, T):
    """Prefill logits and every state leaf, then three decode steps."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(T, (2, T))
    jcache = jlm.init_cache(jcfg, 2, 128)
    jl, jcache = jlm.lm_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                jcache)
    tcache = lm.init_cache(tcfg, 2, 128, device="cpu")
    tl, tcache = lm.lm_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                               tcache)
    _close(tl, jl)
    assert set(tcache) == set(jcache)
    for name in tcache:
        assert tuple(tcache[name].shape) == jcache[name].shape
        _close(tcache[name], jcache[name])
    nxt = _tokens(6, (2, 1))
    for i in range(3):
        jl, jcache = jlm.lm_decode_step(jp, jnp.asarray(nxt), jcfg, jcache,
                                        jnp.int32(T + i))
        tl, tcache = lm.lm_decode_step(tp, torch.from_numpy(nxt), tcfg,
                                       tcache, T + i)
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for name in tcache:
        _close(tcache[name], jcache[name])


def test_short_prompt_decodes_like_the_full_forward(model):
    """A 2-token prompt (shorter than the conv state): prefill, then one
    decode step, gives the full forward's logits at position 2."""
    _, tcfg, _, tp = model
    toks = _tokens(8, (1, 3))
    cache = lm.init_cache(tcfg, 1, 8, device="cpu")
    _, cache = lm.lm_prefill(tp, {"tokens": torch.from_numpy(toks[:, :2])},
                             tcfg, cache)
    got, _ = lm.lm_decode_step(tp, torch.from_numpy(toks[:, 2:]), tcfg,
                               cache, 2)
    want = lm.lm_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(got[:, -1], want[:, -1])


def test_paged_decode_and_dense_batched_decode_of_other_families_raise(
        model):
    _, tcfg, _, tp = model
    with pytest.raises(NotImplementedError, match="KV attention"):
        lm.lm_paged_decode(tp, torch.zeros((1, 1), dtype=torch.int32), tcfg,
                           {}, torch.zeros(1, dtype=torch.int32),
                           torch.zeros((1, 1), dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32), page_size=4)
    with pytest.raises(NotImplementedError, match="models.encdec"):
        make_batched_decode_step(dataclasses.replace(
            get_config("paper_demo", reduced=True), family="audio"))


# ------------------------------------------------------------------- serve
def _prompts(seed=0):
    """Ragged prompt lengths: prime ones past the chunk (37, 67), one
    shorter than the chunk, one of exactly two chunks."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n) for n in (37, 5, 64, 67, 20)]


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


def test_dense_engine_matches_jax_engine_and_both_oracles(model):
    jcfg, tcfg, jp, tp = model
    prompts = _prompts()
    n_new = 8
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=3)
    assert not eng.paged and not eng.fused
    reqs = [Request(p, n_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    m = eng.metrics()
    assert m["retired"] == len(prompts) and m["paged"] is False
    assert eng.pool is None
    assert eng.stats["max_active"] == 3 and eng.idle
    jreqs = [jrequest.Request(p, n_new) for p in prompts]
    jengine.serve_requests(jcfg, jp, jreqs, max_batch=3, paged=False)
    checked = 0
    for p, r, jr in zip(prompts, reqs, jreqs):
        assert r.req_state is RequestState.FINISHED
        ours = greedy_generate(tcfg, tp, p[None], n_new, 128,
                               device="cpu")[0].tolist()
        theirs = np.asarray(jsteps.greedy_generate(
            jcfg, jp, jnp.asarray(p[None], jnp.int32), n_new, 128))[0]
        n = _near_tie_prefix(jcfg, jp, p, theirs)
        assert r.tokens[:n] == jr.tokens[:n] == ours[:n] \
            == theirs[:n].tolist()
        checked += n
    assert checked >= len(prompts) * n_new // 2


def test_dense_engine_frees_slots_after_cancel_eviction_and_stop(model):
    """Cancellation before admission and mid-decode, a single-token
    request and ordinary retirement: every slot ends free and nothing is
    in flight; the survivors' tokens equal the oracle's."""
    _, tcfg, _, tp = model
    prompts = _prompts(1)
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=2, paged=False)
    early = Request(prompts[0], 8)
    mid = Request(prompts[1], 30)
    one = Request(prompts[2], 1)
    rest = Request(prompts[3], 6)
    for r in (early, mid, one, rest):
        eng.submit(r)
    early.cancel()
    eng.close_intake()
    while mid.delivered < 3:
        eng.step()
    mid.cancel()
    eng.run(timeout=60)
    assert early.req_state is RequestState.CANCELLED
    assert mid.req_state is RequestState.CANCELLED
    assert one.req_state is RequestState.FINISHED
    assert rest.req_state is RequestState.FINISHED
    assert eng.active == 0 and eng.idle and eng._inflight == 0
    assert eng.stats["cancelled"] >= 1
    for r, p in ((one, prompts[2]), (rest, prompts[3])):
        want = greedy_generate(tcfg, tp, p[None], len(r.tokens), 64,
                               device="cpu")[0].tolist()
        assert r.tokens == want

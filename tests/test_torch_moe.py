"""The port's MoE family against the JAX package on the CPU:
``qwen3_moe_235b_a22b`` and ``llama4_scout_17b_16e`` reduced (2 layers,
d_model 128, 4 experts: top-2 for qwen3; top-1 plus a shared expert for
llama4) with the reference's weights carried over
(``models.convert.params_from_numpy``).

float32 is held at atol 1e-4 (ATOL), bf16 at the tolerance its test
states. A capacity-based MoE routes each of its input's leading rows as
one group, so the same tokens grouped otherwise may drop other
assignments (ROADMAP C.8): the reference's own no-cache ``lm_forward``
does not give ``greedy_generate``'s tokens. So tokens are held to the JAX
``greedy_generate`` (prefill + decode) up to its own first near tie
(top-2 margin < 1e-3 on its step logits), never to ``lm_forward``; and the
paged suffix and verify steps, whose windows are groups of their own, are
held to the JAX ``lm_paged_decode`` on the same pool, tables and window.
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
from repro.models import moe as jmoe
from repro.serve import steps as jsteps
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.models import lm, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (Request, RequestState, ServeEngine,
                               greedy_generate, make_fused_paged_suffix_step,
                               make_fused_paged_verify_step)

ATOL = 1e-4
MARGIN = 1e-3      # top-2 logit gap below which greedy tokens may flip
NAMES = ["qwen3_moe_235b_a22b", "llama4_scout_17b_16e"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS: dict = {}


def _model(name, bf16=False):
    """(jcfg, tcfg, jax params, port params) of a reduced config, built
    once per process."""
    key = (name, bf16)
    if key not in _MODELS:
        jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
            (jnp.float32, torch.float32)
        jcfg = jax_get_config(name, reduced=True, dtype=jdt, param_dtype=jdt)
        tcfg = get_config(name, reduced=True, dtype=tdt, param_dtype=tdt)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               "cpu")
        _MODELS[key] = (jcfg, tcfg, jp, tp)
    return _MODELS[key]


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _layer(tree, i=0):
    """Layer ``i`` of a stacked (nested) parameter dict."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _grouped_inputs(seed, B, S, d=128):
    """Tokens that share a direction, as a prompt's hidden states do: the
    router sends most of them to the same experts, past their capacity."""
    rng = np.random.default_rng(seed)
    common = rng.normal(size=(B, 1, d))
    return (common + 0.5 * rng.normal(size=(B, S, d))).astype(np.float32)


def _with_dispatch(cfg, dispatch):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch))


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(name, reduced):
    j = jax_get_config(name, reduced=reduced)
    t = get_config(name, reduced=reduced)
    assert name in ARCHITECTURES
    for f in dataclasses.fields(jcommon.ModelConfig):
        if f.name not in ("dtype", "param_dtype", "moe"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for f in dataclasses.fields(jcommon.MoEConfig):
        if f.name != "router_dtype":
            assert getattr(t.moe, f.name) == getattr(j.moe, f.name), f.name
    assert t.moe.router_dtype == torch.float32
    for prop in ("padded_heads", "padded_kv_heads", "padded_kv_groups",
                 "padded_vocab", "resolved_head_dim"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    if not reduced:                     # llama4-scout-17b-a16e too
        assert get_config(t.name) == t


@pytest.mark.parametrize("name", NAMES)
def test_init_params_has_the_reference_tree(name):
    """Same nesting, shapes and dtypes as the reference's ``init_params``;
    the expert stacks at the reference's scale (its ``_init_dense`` takes
    the expert count as fan_in), padded head slots zero."""
    jcfg, tcfg, jp, _ = _model(name)
    ours = lm.init_params(tcfg, seed=1, device="cpu")
    want = jax.tree_util.tree_map(np.asarray, jp)
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_o) == len(flat_w)
    for path, t in flat_o:
        a = flat_w[path]
        assert tuple(t.shape) == a.shape, path
        assert abs(float(t.float().std()) - float(a.std())) \
            <= 0.1 * float(a.std()) + 1e-6, path
    E = tcfg.moe.n_experts
    assert abs(float(ours["layers"]["moe"]["wi"].std()) - E ** -0.5) < 0.02


# -------------------------------------------------------------- moe block
def test_expert_capacity_matches_jax():
    for name in NAMES:
        jcfg, tcfg, _, _ = _model(name)
        for S in (1, 2, 5, 16, 64, 100, 512):
            assert moe.expert_capacity(tcfg, S) == \
                jmoe.expert_capacity(jcfg, S)
    full = get_config("qwen3_moe_235b_a22b")
    # one decode token (or a 5-row verify window) per group: capacity 1
    assert moe.expert_capacity(full, 1) == moe.expert_capacity(full, 5) == 1


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_block_matches_jax_and_drops(name, dispatch):
    """Two groups of 64 tokens that crowd the same experts: both dispatch
    modes equal the reference's block, and assignments past the capacity
    were dropped (their gate zeroed)."""
    jcfg, tcfg, jp, tp = _model(name)
    jcfg, tcfg = _with_dispatch(jcfg, dispatch), _with_dispatch(tcfg,
                                                                dispatch)
    x = _grouped_inputs(1, 2, 64)
    jl, tl = _layer(jp["layers"]["moe"]), _layer(tp["layers"]["moe"])
    got = moe.moe_block(tl, torch.from_numpy(x), tcfg)
    want = jmoe.moe_block(jl, jnp.asarray(x), jcfg)
    _close(got, want)
    _, idx = moe._route(tl, torch.from_numpy(x), tcfg)
    pos = moe._positions_in_expert(idx, tcfg.moe.n_experts)
    dropped = int((pos >= moe.expert_capacity(tcfg, 64)).sum())
    assert dropped > 0
    _, jidx = jmoe._route(jl, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(
        pos.numpy(), np.asarray(jmoe._positions_in_expert(
            jidx, jcfg.moe.n_experts)))


@pytest.mark.parametrize("name", NAMES)
def test_moe_dispatch_modes_agree(name):
    """The two dispatch modes compute one function (same buffer, same
    drops)."""
    _, tcfg, _, tp = _model(name)
    x = torch.from_numpy(_grouped_inputs(2, 3, 40))
    lp = _layer(tp["layers"]["moe"], 1)
    _close(moe.moe_block(lp, x, _with_dispatch(tcfg, "einsum")),
           moe.moe_block(lp, x, _with_dispatch(tcfg, "scatter")))


@pytest.mark.parametrize("name", NAMES)
def test_moe_groups_are_the_leading_rows(name):
    """Row b of a batch gives what it gives routed alone: a group is one
    leading row, never the batch."""
    _, tcfg, _, tp = _model(name)
    x = torch.from_numpy(_grouped_inputs(3, 3, 32))
    lp = _layer(tp["layers"]["moe"])
    both = moe.moe_block(lp, x, tcfg)
    for b in range(3):
        _close(both[b:b + 1], moe.moe_block(lp, x[b:b + 1], tcfg))


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_block_bf16_close_to_jax(name, dispatch):
    """bf16 weights and activations on both sides: XLA and eager PyTorch
    round at different places, so the block agrees to bf16 precision,
    within 3e-2 of its output's scale. The gates are rounded to bf16
    before the combine on both sides."""
    jcfg, tcfg, jp, tp = _model(name, bf16=True)
    jcfg, tcfg = _with_dispatch(jcfg, dispatch), _with_dispatch(tcfg,
                                                                dispatch)
    x = _grouped_inputs(4, 2, 48)
    got = moe.moe_block(_layer(tp["layers"]["moe"]),
                        torch.from_numpy(x).to(torch.bfloat16), tcfg)
    want = np.asarray(jmoe.moe_block(_layer(jp["layers"]["moe"]),
                                     jnp.asarray(x, jnp.bfloat16), jcfg),
                      np.float32)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 3e-2 * np.abs(want).max(), (err, np.abs(want).max())


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("name", NAMES)
def test_lm_forward_matches_jax(name):
    jcfg, tcfg, jp, tp = _model(name)
    toks = _tokens(3, (2, 48))
    got = lm.lm_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    want = jlm.lm_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax(name):
    """Prefill (the whole prompt one group) then four decode steps (one
    token a group): logits and the KV cache equal the reference's."""
    jcfg, tcfg, jp, tp = _model(name)
    S = 37
    toks = _tokens(4, (2, S))
    jc = jlm.init_cache(jcfg, 2, 64)
    jl, jc = jlm.lm_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jc)
    tc = lm.init_cache(tcfg, 2, 64, device="cpu")
    tl, tc = lm.lm_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, tc)
    _close(tl, jl)
    nxt = _tokens(5, (2, 1))
    for i in range(4):
        jl, jc = jlm.lm_decode_step(jp, jnp.asarray(nxt), jcfg, jc,
                                    jnp.int32(S + i))
        tl, tc = lm.lm_decode_step(tp, torch.from_numpy(nxt), tcfg, tc,
                                   S + i)
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for k in ("k", "v"):
        _close(tc[k], jc[k])


def test_converter_refuses_a_tree_of_another_family():
    jcfg, tcfg, jp, _ = _model("qwen3_moe_235b_a22b")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    dense = dataclasses.replace(tcfg, family="dense", moe=None)
    with pytest.raises(ValueError, match="family"):
        params_from_numpy(tree, dense, "cpu")
    wider = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, n_experts=8))
    with pytest.raises(ValueError, match="experts"):
        params_from_numpy(tree, wider, "cpu")


# ------------------------------------------------------------------- serve
def _jax_greedy(jcfg, jp, prompt, n, max_len):
    """The reference's greedy decoding (its ``greedy_generate``: prefill,
    then one decode step a token), with each step's top-2 logit margin."""
    prefill = jax.jit(jsteps.make_prefill_step(jcfg, max_len))
    decode = jax.jit(jsteps.make_decode_step(jcfg))
    logits, cache = prefill(jp, {"tokens": jnp.asarray(prompt[None],
                                                       jnp.int32)})
    toks, margins = [], []
    for i in range(n):
        last = np.asarray(logits[0, -1], np.float32)
        top2 = np.sort(last)[-2:]
        margins.append(top2[1] - top2[0])
        toks.append(int(np.argmax(last)))
        if i + 1 < n:
            logits, cache = decode(jp, cache, jnp.asarray([[toks[-1]]],
                                                          jnp.int32),
                                   jnp.int32(len(prompt) + i))
    return toks, margins


def _near_tie(margins) -> int:
    small = [i for i, m in enumerate(margins) if m < MARGIN]
    return small[0] if small else len(margins)


@pytest.mark.parametrize("name", NAMES)
def test_paged_engine_cold_requests_match_jax_greedy(name):
    """The paged, fused engine on cold requests (no shared prefix): each
    prompt is prefilled as one group and each decode step routes one token
    a slot, as the reference's ``greedy_generate`` does; tokens equal it
    (and the port's ``greedy_generate``) up to its first near tie."""
    jcfg, tcfg, jp, tp = _model(name)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, n) for n in (7, 29, 13, 40)]
    n_new = 8
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=3, page_size=8,
                      max_seq_len=64)
    assert eng.paged
    reqs = [Request(p, n_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    assert all(r.req_state is RequestState.FINISHED for r in reqs)
    assert eng.metrics()["pages_in_use"] == 0
    assert eng.pool.stats["prefix_hits"] == 0
    eng.shutdown()
    want0 = np.asarray(jsteps.greedy_generate(
        jcfg, jp, jnp.asarray(prompts[0][None], jnp.int32), n_new,
        64))[0].tolist()
    checked = 0
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        theirs, margins = _jax_greedy(jcfg, jp, p, n_new, 64)
        if i == 0:
            assert theirs == want0
        n = _near_tie(margins)
        ours = greedy_generate(tcfg, tp, p[None], n_new, 64,
                               device="cpu")[0].tolist()
        assert r.tokens[:n] == ours[:n] == theirs[:n]
        checked += n
    assert checked >= len(prompts) * n_new // 2


def _pool_case(tcfg, seed, positions, W, ps=8, T=8):
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


def _jax_paged(jcfg, jp, toks, pool, positions, tables, n_valid, ps):
    return jlm.lm_paged_decode(
        jp, jnp.asarray(toks), jcfg,
        {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(positions, jnp.int32), jnp.asarray(tables),
        jnp.asarray(n_valid, jnp.int32), page_size=ps)


@pytest.mark.parametrize("name", NAMES)
def test_fused_suffix_step_matches_jax_paged_decode(name):
    """A suffix prefill after a prefix hit: one slot's 16-row window (13
    real rows, padded to the page) at position 24 is ONE routing group, in
    both packages; logits of the real rows and the pages written equal the
    reference's ``lm_paged_decode`` on the same pool and tables."""
    jcfg, tcfg, jp, tp = _model(name)
    ps, W, positions, n_valid = 8, 16, [24], [13]
    pool, tables, null = _pool_case(tcfg, 7, positions, W, ps)
    toks = _tokens(8, (1, W))
    jl, jpool = _jax_paged(jcfg, jp, toks, pool, positions, tables, n_valid,
                           ps)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    tl, tpool = make_fused_paged_suffix_step(tcfg, ps)(
        tp, tpool, torch.from_numpy(toks),
        torch.tensor(positions, dtype=torch.int32), torch.from_numpy(tables),
        torch.tensor(n_valid, dtype=torch.int32))
    _close(tl[:, :13], np.asarray(jl)[:, :13])
    for k in ("k", "v"):
        _close(tpool[k][:, :null], np.asarray(jpool[k])[:, :null])


@pytest.mark.parametrize("name", NAMES)
def test_fused_verify_step_matches_jax_paged_decode(name):
    """A speculative verify over 4 slots, each window of 1 + 4 rows one
    routing group (capacity 3 for qwen3's reduced top-2 of 4 experts, so
    colliding drafts may be dropped, as in the reference): the emitted
    tokens are the argmaxes of the reference's ``lm_paged_decode`` logits
    over the same windows, and the logits equal them."""
    jcfg, tcfg, jp, tp = _model(name)
    ps, K = 8, 4
    positions, n_valid = [3, 17, 9, 30], [5, 5, 0, 3]
    pool, tables, _ = _pool_case(tcfg, 9, positions, 1 + K, ps)
    toks = _tokens(10, (4, 1 + K))
    jl, _ = _jax_paged(jcfg, jp, toks, pool, positions, tables, n_valid, ps)
    jl = np.asarray(jl)
    args = (torch.tensor(positions, dtype=torch.int32),
            torch.from_numpy(tables), torch.tensor(n_valid, dtype=torch.int32))
    emitted, accepts, _ = make_fused_paged_verify_step(tcfg, ps, K)(
        tp, {k: torch.from_numpy(v.copy()) for k, v in pool.items()},
        torch.from_numpy(toks)[:, None], *args)
    tl, _ = lm.lm_paged_decode(
        tp, torch.from_numpy(toks), tcfg,
        {k: torch.from_numpy(v.copy()) for k, v in pool.items()}, *args,
        page_size=ps)
    live = np.asarray(n_valid) > 0
    _close(tl.numpy()[live], jl[live])
    top2 = np.sort(jl, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] >= MARGIN) & live[:, None]
    np.testing.assert_array_equal(emitted.numpy()[clear],
                                  jl.argmax(-1)[clear])
    assert accepts.shape == (4,)

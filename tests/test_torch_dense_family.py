"""The port's dense family beyond ``paper_demo`` against the JAX package on
the CPU, float32, with the reference's weights carried over
(``models.convert.params_from_numpy``):

* ``h2o_danube3_4b`` reduced (window 64, head_dim 32; untied, as the full
  config is, though ``reduced()`` ties): the sliding-window forward, the
  ring cache after prefill and decode, and the engine's dense mode;
* ``command_r_plus_104b`` reduced: the parallel block (attention and MLP
  share one pre-norm, no ``norm2``), model and paged engine;
* a padded-GQA case (``deepseek_coder_33b`` reduced with 14 q-heads over 2
  KV heads, padded to 16: 7 real of 8 per group, as deepseek has), model
  and paged engine;
* per-row dense decode: slots at different positions in one batch.

Logits and caches are held at atol 1e-4 (ATOL). Greedy tokens are held
to the JAX ``greedy_generate`` up to its first near tie (top-2 margin <
1e-3), and only where the reference's cached path is right: after a
prompt longer than the window with ``S % window != 0`` the reference's
ring is misaligned (ROADMAP C.6), so there the port's cached decode is
held to the JAX ``lm_forward`` (no cache) instead.
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
from repro.serve import steps as jsteps
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.models import attention, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (Request, RequestState, ServeEngine,
                               greedy_generate, make_batched_decode_step)

ATOL = 1e-4
MARGIN = 1e-3      # top-2 logit gap below which greedy tokens may flip
WINDOW = 64        # reduced h2o_danube3_4b's sliding window

# reduced config name -> overrides on both sides
CASES = {
    "danube": ("h2o_danube3_4b", dict(tied_embeddings=False)),
    "command_r": ("command_r_plus_104b", {}),
    "padded_gqa": ("deepseek_coder_33b",
                   dict(n_heads=14, n_kv_heads=2, head_pad_to=16)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS: dict = {}


def _model(case):
    """(jcfg, tcfg, jax params, port params) of a reduced case, built once
    per process."""
    if case not in _MODELS:
        name, over = CASES[case]
        jcfg = jax_get_config(name, reduced=True, dtype=jnp.float32,
                              param_dtype=jnp.float32, **over)
        tcfg = get_config(name, reduced=True, dtype=torch.float32,
                          param_dtype=torch.float32, **over)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               "cpu")
        _MODELS[case] = (jcfg, tcfg, jp, tp)
    return _MODELS[case]


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _jax_forward(jcfg, jp, seq):
    return np.asarray(jlm.lm_forward(
        jp, {"tokens": jnp.asarray(np.asarray(seq, np.int32)[None])},
        jcfg))[0]


def _near_tie_prefix(jcfg, jp, prompt, tokens):
    """Generated positions before the first whose JAX top-2 logit margin
    (teacher-forced over the sequence) is below MARGIN."""
    logits = _jax_forward(jcfg, jp, np.concatenate([prompt, tokens]))
    steps = logits[len(prompt) - 1:len(prompt) - 1 + len(tokens)]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    small = np.nonzero(top2[:, 1] - top2[:, 0] < MARGIN)[0]
    return len(tokens) if len(small) == 0 else int(small[0])


def _forward_greedy(jcfg, jp, prompt, n):
    """Greedy tokens by the JAX ``lm_forward`` over the growing sequence
    (no cache)."""
    seq = list(prompt)
    for _ in range(n):
        seq.append(int(np.argmax(_jax_forward(jcfg, jp, seq)[-1])))
    return seq[len(prompt):]


def _serve(tcfg, tp, prompts, n_new, **kw):
    eng = ServeEngine(tcfg, tp, device="cpu", **kw)
    reqs = [Request(p, n_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    assert all(r.req_state is RequestState.FINISHED for r in reqs)
    assert eng.idle and eng.active == 0
    if eng.paged:
        assert eng.metrics()["pages_in_use"] == 0
    eng.shutdown()
    return eng, reqs


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("name", ["h2o_danube3_4b", "deepseek_coder_33b",
                                  "llama3_405b", "command_r_plus_104b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(name, reduced):
    j = jax_get_config(name, reduced=reduced)
    t = get_config(name, reduced=reduced)
    assert name in ARCHITECTURES
    for f in dataclasses.fields(jcommon.ModelConfig):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for prop in ("kv_groups", "padded_heads", "padded_kv_heads",
                 "padded_kv_groups", "padded_vocab", "resolved_head_dim"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.param_count() == j.param_count()
    assert get_config(name.replace("_", "-")) == get_config(name)


@pytest.mark.parametrize("name", ARCHITECTURES)
def test_config_resolves_by_its_own_name(name):
    """``cfg.name`` (the published spelling, hyphenated) names the same
    config: h2o-danube-3-4b's module is ``h2o_danube3_4b``."""
    assert get_config(get_config(name).name) == get_config(name)


def test_full_configs_head_dims_are_instantiated():
    """Every ported dense config's head_dim has a flash instantiation, and
    every paged one a paged instantiation."""
    from repro_torch.kernels import flash_attention, paged_attention
    from repro_torch.serve.kv_cache import paged_supported
    for name in ("paper_demo", "h2o_danube3_4b", "deepseek_coder_33b",
                 "llama3_405b", "command_r_plus_104b"):
        cfg = get_config(name)
        assert cfg.resolved_head_dim in flash_attention.HEAD_DIMS
        if paged_supported(cfg):
            assert cfg.resolved_head_dim in paged_attention.HEAD_DIMS
    assert not paged_supported(get_config("h2o_danube3_4b"))


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("case", list(CASES))
def test_lm_forward_matches_jax(case):
    """At 100 tokens the danube forward runs past its 64-token window."""
    jcfg, tcfg, jp, tp = _model(case)
    toks = _tokens(3, (2, 100))
    got = lm.lm_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    want = jlm.lm_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _close(got, want)


@pytest.mark.parametrize("case,S", [("danube", 40), ("danube", 64),
                                    ("command_r", 21), ("padded_gqa", 21)])
def test_prefill_and_decode_match_jax(case, S):
    """Prefill then four decode steps, logits and the whole cache against
    the JAX package's; for danube ``S <= window`` with ``S % window`` 0 or
    ``S < window``, where the reference's ring is aligned (the steps from
    64 wrap the ring)."""
    jcfg, tcfg, jp, tp = _model(case)
    toks = _tokens(4, (2, S))
    jc = jlm.init_cache(jcfg, 2, 96)
    jl, jc = jlm.lm_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jc)
    tc = lm.init_cache(tcfg, 2, 96, device="cpu")
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
    for name in ("k", "v"):
        _close(tc[name], jc[name])


@pytest.mark.parametrize("S", [70, 100, 128, 191])
def test_ring_after_long_prompt_matches_jax_forward(S):
    """A prompt longer than the window, then three decode steps: each step's
    logits equal the JAX ``lm_forward``'s last row over the whole sequence
    (the reference's own cached path is wrong at 70, 100 and 191, where
    ``S % 64 != 0``; 128 is a multiple)."""
    jcfg, tcfg, jp, tp = _model("danube")
    seq = _tokens(6, (1, S + 3))
    cache = lm.init_cache(tcfg, 1, 256, device="cpu")
    assert cache["k"].shape[2] == WINDOW
    logits, cache = lm.lm_prefill(
        tp, {"tokens": torch.from_numpy(seq[:, :S])}, tcfg, cache)
    _close(logits[0, -1], _jax_forward(jcfg, jp, seq[0, :S])[-1])
    for i in range(3):
        logits, cache = lm.lm_decode_step(
            tp, torch.from_numpy(seq[:, S + i:S + i + 1]), tcfg, cache,
            S + i)
        _close(logits[0, -1], _jax_forward(jcfg, jp, seq[0, :S + i + 1])[-1])


def test_prefill_ring_holds_position_p_at_slot_p_mod_window():
    """After a 100-token prompt the ring's slot ``p % 64`` holds the key of
    position ``p`` for the last 64 positions: the no-cache forward's keys,
    rolled."""
    _, tcfg, _, tp = _model("danube")
    S = 100
    toks = torch.from_numpy(_tokens(7, (1, S)))
    cache = lm.init_cache(tcfg, 1, 256, device="cpu")
    _, cache = lm.lm_prefill(tp, {"tokens": toks}, tcfg, cache)
    x = lm.embed_tokens(tp["embed"], toks, tcfg)
    lp = lm.layer_views(tp)[0]
    h = lm.rmsnorm(lp["norm1"], x, tcfg.norm_eps)
    rope = lm._rope(tcfg, torch.arange(S)[None])
    _, k, _ = attention._project_qkv(lp["attn"], h, tcfg, rope)
    for p in range(S - WINDOW, S):
        torch.testing.assert_close(cache["k"][0, 0, p % WINDOW], k[0, p],
                                   atol=0, rtol=0)


def test_parallel_block_tree_has_no_norm2():
    jcfg, tcfg, jp, tp = _model("command_r")
    assert tcfg.parallel_block and "norm2" not in tp["layers"]
    assert "norm2" not in lm.init_params(tcfg, seed=0, device="cpu")["layers"]
    serial = dataclasses.replace(tcfg, parallel_block=False)
    assert "norm2" in lm.init_params(serial, seed=0, device="cpu")["layers"]
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match="norm2"):
        params_from_numpy(tree, serial, "cpu")


def test_padded_heads_carry_zero_weights():
    """14 real q-heads over 2 KV heads, padded to 16: the padded slot of
    each group of 8 has zero q and o weights, from either package."""
    _, tcfg, _, tp = _model("padded_gqa")
    assert (tcfg.padded_heads, tcfg.padded_kv_heads,
            tcfg.padded_kv_groups) == (16, 2, 8)
    pad = ~attention.head_mask(tcfg)
    assert pad.tolist() == [False] * 7 + [True] + [False] * 7 + [True]
    for params in (tp, lm.init_params(tcfg, seed=0, device="cpu")):
        assert float(params["layers"]["attn"]["wq"][:, :, pad].abs().max()) \
            == 0
        assert float(params["layers"]["attn"]["wo"][:, pad].abs().max()) == 0


@pytest.mark.parametrize("case", ["danube", "command_r"])
def test_per_row_decode_equals_rows_decoded_alone(case):
    """One decode of a 3-row batch with the rows at positions 9, 70 and 33
    (a ``(B,)`` tensor) gives each row's logits and cache rows as decoding
    that row alone at its int position does."""
    _, tcfg, _, tp = _model(case)
    lens = [9, 70, 33]
    cache = lm.init_cache(tcfg, 3, 96, device="cpu")
    for b, n in enumerate(lens):
        rows = {k: t[:, b:b + 1] for k, t in cache.items()}
        lm.lm_prefill(tp, {"tokens": torch.from_numpy(_tokens(b, (1, n)))},
                      tcfg, rows)
    alone = {k: t.clone() for k, t in cache.items()}
    nxt = torch.from_numpy(_tokens(8, (3, 1)))
    got, cache = lm.lm_decode_step(tp, nxt, tcfg, cache,
                                   torch.tensor(lens, dtype=torch.int32))
    for b, n in enumerate(lens):
        rows = {k: t[:, b:b + 1] for k, t in alone.items()}
        want, _ = lm.lm_decode_step(tp, nxt[b:b + 1], tcfg, rows, n)
        _close(got[b], want[0])
        for name in ("k", "v"):
            _close(cache[name][:, b], alone[name][:, b])


def test_windowed_multi_token_decode_raises():
    _, tcfg, _, tp = _model("danube")
    cache = lm.init_cache(tcfg, 1, 64, device="cpu")
    with pytest.raises(NotImplementedError, match="SWA ring"):
        lm.lm_decode_step(tp, torch.zeros((1, 2), dtype=torch.int32), tcfg,
                          cache, 3)


@pytest.mark.parametrize("case,L", [("command_r", 16), ("danube", 32)])
def test_host_decode_past_a_cache_that_is_no_ring_raises(case, L):
    """Without a window, or on a cache shorter than the window, a decode
    at a host position past the cache raises instead of wrapping onto
    keys it still attends; a whole-window ring wraps."""
    _, tcfg, _, tp = _model(case)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    cache = lm.init_cache(tcfg, 1, L, device="cpu")
    lm.lm_decode_step(tp, tok, tcfg, cache, L - 1)
    with pytest.raises(ValueError, match="past a cache"):
        lm.lm_decode_step(tp, tok, tcfg, cache, L)
    if case == "danube":
        ring = lm.init_cache(tcfg, 1, WINDOW, device="cpu")
        lm.lm_decode_step(tp, tok, tcfg, ring, WINDOW + 5)


# ------------------------------------------------------------------- serve
def test_danube_engine_dense_mode_matches_jax_greedy():
    """Dense mode (chosen automatically: a window has no paged cache),
    prompts up to the window decoding past it, against both
    ``greedy_generate`` oracles."""
    jcfg, tcfg, jp, tp = _model("danube")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n) for n in (5, 40, 60, 64)]
    n_new = 10
    eng, reqs = _serve(tcfg, tp, prompts, n_new, max_batch=3,
                       max_cache_len=128)
    assert not eng.paged and eng._cache["k"].shape[2] == WINDOW
    assert eng.stats["max_active"] == 3
    checked = 0
    for p, r in zip(prompts, reqs):
        theirs = np.asarray(jsteps.greedy_generate(
            jcfg, jp, jnp.asarray(p[None], jnp.int32), n_new, 128))[0]
        ours = greedy_generate(tcfg, tp, p[None], n_new, 128,
                               device="cpu")[0].tolist()
        n = _near_tie_prefix(jcfg, jp, p, theirs)
        assert r.tokens[:n] == ours[:n] == theirs[:n].tolist()
        checked += n
    assert checked >= len(prompts) * n_new // 2


def test_danube_engine_long_prompts_match_forward_greedy():
    """Prompts of 70 and 100 tokens (``% 64 != 0``) through the engine's
    ring: the tokens equal greedy by the JAX ``lm_forward`` (no cache)."""
    jcfg, tcfg, jp, tp = _model("danube")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 512, n) for n in (70, 100)]
    n_new = 6
    _, reqs = _serve(tcfg, tp, prompts, n_new, max_batch=2,
                     max_cache_len=128)
    for p, r in zip(prompts, reqs):
        want = _forward_greedy(jcfg, jp, p, n_new)
        n = _near_tie_prefix(jcfg, jp, p, want)
        assert r.tokens[:n] == want[:n]
        assert greedy_generate(tcfg, tp, p[None], n_new, 128,
                               device="cpu")[0].tolist()[:n] == want[:n]


@pytest.mark.parametrize("case", ["command_r", "padded_gqa"])
def test_paged_engine_matches_jax_greedy(case):
    jcfg, tcfg, jp, tp = _model(case)
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 512, 16)
    prompts = [rng.integers(0, 512, 13),
               np.concatenate([prefix, rng.integers(0, 512, 5)]),
               np.concatenate([prefix, rng.integers(0, 512, 9)])]
    n_new = 8
    eng, reqs = _serve(tcfg, tp, prompts, n_new, max_batch=2, page_size=8,
                       max_seq_len=64)
    assert eng.paged
    checked = 0
    for p, r in zip(prompts, reqs):
        theirs = np.asarray(jsteps.greedy_generate(
            jcfg, jp, jnp.asarray(p[None], jnp.int32), n_new, 64))[0]
        n = _near_tie_prefix(jcfg, jp, p, theirs)
        assert r.tokens[:n] == theirs[:n].tolist()
        checked += n
    assert checked >= len(prompts) * n_new // 2


@pytest.mark.parametrize("case", ["command_r", "padded_gqa"])
def test_dense_mode_of_a_full_attention_config(case):
    """``paged=False`` on a full-attention config: slots decode at their
    own positions, tokens equal the paged engine's and the port's greedy;
    a request longer than the dense cache is refused at submit."""
    jcfg, tcfg, jp, tp = _model(case)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 512, n) for n in (3, 17, 30)]
    n_new = 8
    eng, dense = _serve(tcfg, tp, prompts, n_new, max_batch=2,
                        max_cache_len=48, paged=False)
    assert not eng.paged and eng.pool is None
    _, paged = _serve(tcfg, tp, prompts, n_new, max_batch=2, page_size=8,
                      max_seq_len=48)
    for p, d, q in zip(prompts, dense, paged):
        ours = greedy_generate(tcfg, tp, p[None], n_new, 48,
                               device="cpu")[0].tolist()
        n = _near_tie_prefix(jcfg, jp, p, ours)
        assert d.tokens[:n] == q.tokens[:n] == ours[:n]
    eng = ServeEngine(tcfg, tp, device="cpu", max_cache_len=48, paged=False)
    with pytest.raises(ValueError, match="dense cache"):
        eng.submit(Request(prompts[2], 19))
    eng.submit(Request(prompts[2], 18))
    eng.shutdown()


def test_windowed_dense_cache_shorter_than_the_window_bounds_requests():
    """A ring shorter than the window would drop keys the window still
    sees: requests past it are refused; a whole-window ring takes any
    length."""
    _, tcfg, _, tp = _model("danube")
    short = ServeEngine(tcfg, tp, device="cpu", max_cache_len=32)
    with pytest.raises(ValueError, match="dense cache"):
        short.submit(Request(_tokens(1, 30), 3))
    short.shutdown()
    ring = ServeEngine(tcfg, tp, device="cpu", max_cache_len=64)
    ring.submit(Request(_tokens(1, 300), 40))
    ring.shutdown()


def test_batched_decode_step_writes_each_slot_at_its_position():
    """``make_batched_decode_step`` with per-slot positions writes each
    slot's new key at its own ring slot and leaves the others' rows."""
    _, tcfg, _, tp = _model("danube")
    step = make_batched_decode_step(tcfg)
    cache = lm.init_cache(tcfg, 3, 64, device="cpu")
    before = {k: t.clone() for k, t in cache.items()}
    positions = torch.tensor([0, 63, 130], dtype=torch.int32)
    toks = torch.from_numpy(_tokens(13, (3, 1, 1)))
    nxt, cache = step(tp, cache, toks, positions)
    assert nxt.shape == (3, 1) and nxt.dtype == torch.int32
    changed = (cache["k"] != before["k"]).flatten(3).any(-1)   # (L, B, T)
    for b, p in enumerate([0, 63, 130]):
        want = torch.zeros(WINDOW, dtype=torch.bool)
        want[p % WINDOW] = True
        assert torch.equal(changed[0, b], want)

"""The port's dense decoder against the JAX package, with the JAX package's
own weights carried over (``models.convert.params_from_numpy``).

Model-level comparisons run ``paper_demo`` reduced, in float32 on both
sides, at atol 1e-4 on logits and K/V; one bf16 case at a looser stated
tolerance. The JAX side runs its default "xla" reference path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import common as tcommon
from repro_torch.models import attention, layers, lm, ssm
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.serve.kv_cache import PagePool

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype=jnp.float32, tdtype=torch.float32):
    jcfg = jax_get_config("paper_demo", reduced=True, dtype=dtype,
                          param_dtype=dtype)
    tcfg = get_config("paper_demo", reduced=True, dtype=tdtype,
                      param_dtype=tdtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def f32():
    jcfg, tcfg = _cfgs()
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
@pytest.mark.parametrize("overrides", [{}, {"head_pad_to": 16,
                                            "vocab_pad_to": 1000}])
def test_config_fields_and_derived_properties(reduced, overrides):
    j = jax_get_config("paper_demo", reduced=reduced, **overrides)
    t = get_config("paper_demo", reduced=reduced, **overrides)
    for f in dataclasses.fields(jcommon.ModelConfig):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.dtype is torch.bfloat16 and t.param_dtype is torch.bfloat16
    for prop in ("kv_groups", "padded_heads", "padded_kv_heads",
                 "padded_kv_groups", "padded_vocab", "resolved_head_dim"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.param_count() == j.param_count()
    assert {f.name for f in dataclasses.fields(tcommon.ModelConfig)} == \
        {f.name for f in dataclasses.fields(jcommon.ModelConfig)}


def test_init_params_shapes_and_scales():
    jcfg, tcfg = _cfgs()
    jp = jax.tree_util.tree_map(np.asarray,
                                jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tp = lm.init_params(tcfg, seed=3, device="cpu")
    jl, jtree = jax.tree_util.tree_flatten(jp)
    tl, ttree = jax.tree_util.tree_flatten(tp)
    assert jtree == ttree
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        # same init scales (the draws differ: another generator)
        assert abs(float(b.std()) - float(a.std())) <= 0.1 * float(a.std()) \
            + 1e-6
    again = lm.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(tp["layers"]["attn"]["wq"],
                       again["layers"]["attn"]["wq"])


def test_bf16_leaves_convert_bit_exactly():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    t = tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_other_families_not_ported():
    """Every family of the reference is ported; the decoder-only model
    functions refuse the audio enc-dec (``models.encdec`` runs it), a
    frontend outside the VLM family, and a VLM without its frontend; an
    unknown config name raises."""
    jcfg, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="encdec"):
        lm.init_params(dataclasses.replace(tcfg, family="audio"),
                       device="cpu")
    with pytest.raises(ValueError, match="frontend_dim"):
        lm.init_params(dataclasses.replace(tcfg, family="vlm"),
                       device="cpu")
    with pytest.raises(NotImplementedError):
        lm.init_params(dataclasses.replace(tcfg, frontend_dim=64),
                       device="cpu")
    assert [get_config(name).family for name in
            ("whisper_large_v3", "internvl2_26b")] == ["audio", "vlm"]
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("no_such_model")


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("lean", [False, True])
def test_apply_rope_matches_jax(lean):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [40]])).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10000.0, lean=lean)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                              lean=lean)
    _close(got, want, atol=1e-5)


def test_mlp_embed_and_padded_logits_match_jax(f32):
    jcfg, tcfg, jp, tp = f32
    cfg_j = dataclasses.replace(jcfg, vocab_pad_to=96)
    cfg_t = dataclasses.replace(tcfg, vocab_pad_to=96)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    lj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mlp"])
    lt = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    _close(layers.mlp(lt, torch.from_numpy(x)),
           jlayers.mlp(lj, jnp.asarray(x)))
    emb = rng.normal(size=(cfg_j.padded_vocab, 128)).astype(np.float32)
    toks = _tokens(2, (2, 5))
    _close(layers.embed_tokens({"tokens": torch.from_numpy(emb)},
                               torch.from_numpy(toks), cfg_t),
           jlayers.embed_tokens({"tokens": jnp.asarray(emb)},
                                jnp.asarray(toks), cfg_j))
    got = layers.lm_logits({"tokens": torch.from_numpy(emb)},
                           torch.from_numpy(x), cfg_t)
    want = jlayers.lm_logits({"tokens": jnp.asarray(emb)}, jnp.asarray(x),
                             cfg_j)
    assert cfg_t.padded_vocab > cfg_t.vocab_size
    _close(got, want)


# ------------------------------------------------------------------- model
def test_lm_forward_matches_jax(f32):
    jcfg, tcfg, jp, tp = f32
    toks = _tokens(3, (2, 19))
    got = lm.lm_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    want = jlm.lm_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _close(got, want)


def _prefill_both(f32, toks, max_len):
    jcfg, tcfg, jp, tp = f32
    jcache = jlm.init_cache(jcfg, toks.shape[0], max_len)
    jl, jcache = jlm.lm_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                jcache)
    tcache = lm.init_cache(tcfg, toks.shape[0], max_len, device="cpu")
    tl, tcache = lm.lm_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                               tcache)
    return (jl, jcache), (tl, tcache)


def test_lm_prefill_matches_jax(f32):
    toks = _tokens(4, (2, 21))
    (jl, jc), (tl, tc) = _prefill_both(f32, toks, 32)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name])


def test_lm_decode_step_matches_jax(f32):
    jcfg, tcfg, jp, tp = f32
    toks = _tokens(5, (2, 12))
    (_, jc), (_, tc) = _prefill_both(f32, toks, 24)
    nxt = _tokens(6, (2, 1))
    for i in range(3):
        jl, jc = jlm.lm_decode_step(jp, jnp.asarray(nxt), jcfg, jc,
                                    jnp.int32(12 + i))
        tl, tc = lm.lm_decode_step(tp, torch.from_numpy(nxt), tcfg, tc,
                                   12 + i)
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for name in ("k", "v"):
        _close(tc[name], jc[name])


def _pool_case(tcfg, seed, positions, n_valid, W, ps=8, T=6):
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


@pytest.mark.parametrize("W,positions,n_valid", [
    (1, [3, 17, 8, 30], [1, 1, 0, 1]),          # decode, one idle slot
    (16, [24], [13]),                           # suffix window
])
def test_lm_paged_decode_matches_jax(f32, W, positions, n_valid):
    jcfg, tcfg, jp, tp = f32
    ps = 8
    pool, tables, null = _pool_case(tcfg, 7, positions, n_valid, W, ps)
    toks = _tokens(8, (len(positions), W))
    jl, jpool = jlm.lm_paged_decode(
        jp, jnp.asarray(toks), jcfg, {k: jnp.asarray(v) for k, v in
                                      pool.items()},
        jnp.asarray(positions, jnp.int32), jnp.asarray(tables),
        jnp.asarray(n_valid, jnp.int32), page_size=ps)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    tl, tpool = lm.lm_paged_decode(
        tp, torch.from_numpy(toks), tcfg, tpool,
        torch.tensor(positions, dtype=torch.int32), torch.from_numpy(tables),
        torch.tensor(n_valid, dtype=torch.int32), page_size=ps)
    live = np.asarray(n_valid) > 0
    _close(tl[live], np.asarray(jl)[live])
    for name in ("k", "v"):
        # K/V written to real pages match; the null page is excluded by
        # contract (the reference parks masked rows there)
        _close(tpool[name][:, :null], np.asarray(jpool[name])[:, :null])


def test_bf16_forward_close_to_jax():
    """bf16 on both sides rounds at different places (XLA fuses and
    keeps some intermediates in fp32; eager PyTorch rounds after every
    op), so logits agree only to bf16 precision: max error within 3e-2
    of the logits' scale."""
    jcfg, tcfg = _cfgs(jnp.bfloat16, torch.bfloat16)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    toks = _tokens(9, (2, 16))
    got = lm.lm_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    want = np.asarray(jlm.lm_forward(jp, {"tokens": jnp.asarray(toks)},
                                     jcfg), np.float32)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 3e-2 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("make", [
    lambda cfg, scfg: PagePool(cfg, 4, 4),
    lambda cfg, scfg: lm.init_cache(cfg, 1, 8),
    lambda cfg, scfg: attention.init_kv_cache(cfg, 1, 8),
    lambda cfg, scfg: ssm.init_ssm_state(scfg, 1),
    lambda cfg, scfg: tensor_from_numpy(np.zeros(3, np.float32)),
], ids=["PagePool", "init_cache", "init_kv_cache", "init_ssm_state",
        "tensor_from_numpy"])
def test_constructors_default_to_the_card(make):
    """Called without ``device``, each public constructor places its
    tensors on the card, so where there is none it raises rather than
    landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")
    _, tcfg = _cfgs()
    scfg = get_config("mamba2_370m", reduced=True, dtype=torch.float32,
                      param_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(tcfg, scfg)

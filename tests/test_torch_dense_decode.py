"""Dense decode through the paged kernel's route on the CPU: the cache
read in place as a page pool (``attention.dense_pages``) against the
grouped einsums (``attention._grouped``) kept as the plain reference, and
the models' decode steps on that route against the JAX package.

On the CPU the paged wrapper takes its plain version, so these tests hold
the route's indexing (page size, identity tables, positions, the rows it
writes) to ``_grouped``'s; ``tests/test_torch_gpu.py`` holds the kernel to
it on the card. The reduced configs have head_dim 32, which the kernel
lacks; the model tests set 64 on both sides so that the route runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.serve import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as paged_kernel
from repro_torch.models import attention, lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import make_decode_step, make_prefill_step

ATOL = 1e-4       # the port's float32 parity tolerance against JAX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(hd, G, window=0):
    KV = 2
    return ModelConfig(d_model=64, n_heads=KV * G, n_kv_heads=KV,
                       head_dim=hd, head_pad_to=1, window=window,
                       dtype=torch.float32, param_dtype=torch.float32)


def _inputs(cfg, B, L, S1, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = attention.init_attention(cfg, gen, torch.device("cpu"))
    x = torch.randn((B, S1, cfg.d_model), generator=gen)
    shape = (B, L, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.randn(shape, generator=gen),
             "v": torch.randn(shape, generator=gen)}
    return params, x, cache


def _grouped_decode(params, x, cfg, cache, pos):
    """The decode as ``_grouped`` computes it: the new rows written at
    ``qpos % L``, each row attending positions up to its own."""
    B, S1, _ = x.shape
    L = cache["k"].shape[1]
    qpos = pos[:, None] + torch.arange(S1)[None, :]
    q, k, v = attention._project_qkv(params, x, cfg,
                                     attention._rope(cfg, qpos))
    attention._write_rows(cache, k, v, qpos % L)
    valid = torch.arange(L)[None, None, :] <= qpos[:, :, None]
    o = attention._grouped(q, cache["k"], cache["v"], valid, cfg)
    return attention._out_proj(params, o, cfg)


@pytest.fixture
def paged_calls(monkeypatch):
    """Counts the decode's calls of the paged wrapper (its ``LAUNCHES``
    counts only the CUDA path)."""
    calls = []
    real = paged_kernel.paged_attention

    def spy(*args, **kw):
        calls.append(kw["page_size"])
        return real(*args, **kw)
    monkeypatch.setattr(paged_kernel, "paged_attention", spy)
    return calls


@pytest.mark.parametrize("L,ps", [(256, 64), (200, 8)])
@pytest.mark.parametrize("S1", [1, 3])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_dense_decode_through_the_paged_route_equals_grouped(
        paged_calls, hd, G, S1, L, ps):
    """Rows at position 0, mid-cache and at the cache's end, an idle slot
    at the engine's idle position (0), and a draining slot past the cache:
    every row's output agrees with ``_grouped``'s within fp32 rounding but
    the draining slot's, and the caches are equal but on the draining
    slot's own row, the only one its write may touch."""
    cfg = _cfg(hd, G)
    pos = torch.tensor([0, L // 2, L - S1, 0, 17, L])
    B = pos.shape[0]
    params, x, cache = _inputs(cfg, B, L, S1)
    ref_cache = {n: t.clone() for n, t in cache.items()}
    before = {n: t.clone() for n, t in cache.items()}
    out, _ = attention.decode_attention(params, x, cfg, cache, pos)
    ref = _grouped_decode(params, x, cfg, ref_cache, pos)
    assert paged_calls == [ps]
    live = slice(0, B - 1)
    torch.testing.assert_close(out[live], ref[live])
    for n in ("k", "v"):
        assert torch.equal(cache[n][live], ref_cache[n][live])
        # the draining slot writes its own row's last page, not another's
        assert torch.equal(cache[n][-1, :L - ps], before[n][-1, :L - ps])


def test_dense_pages_names_each_rows_own_pages():
    """The index names row ``b``'s pages ``b·T ..`` in order, as int32,
    with the largest page size up to 64 that divides the cache; None for a
    sliding-window ring and an uninstantiated head_dim."""
    pages = attention.dense_pages(_cfg(64, 4), 3, 4096, torch.tensor(
        [5, 6, 7]), 1, torch.device("cpu"))
    assert pages.page_size == 64
    assert pages.tables.dtype == pages.positions.dtype == torch.int32
    assert torch.equal(pages.tables[2], torch.arange(128, 192,
                                                     dtype=torch.int32))
    assert pages.positions.tolist() == [5, 6, 7]
    assert pages.n_valid.tolist() == [1, 1, 1]
    assert attention.dense_pages(_cfg(64, 4), 2, 97, 3, 2,
                                 "cpu").page_size == 1
    assert attention.dense_pages(_cfg(64, 4, window=32), 2, 32, 3, 1,
                                 "cpu") is None
    assert attention.dense_pages(_cfg(32, 4), 2, 64, 3, 1, "cpu") is None


def test_a_window_and_an_uninstantiated_head_dim_keep_grouped(paged_calls):
    for cfg in (_cfg(64, 4, window=32), _cfg(32, 4)):
        params, x, cache = _inputs(cfg, 2, 32, 1)
        attention.decode_attention(params, x, cfg, cache, 5)
    assert paged_calls == []


def test_the_page_view_raises_on_a_cache_it_cannot_view_in_place():
    """A cache laid out (B, KV, L, hd) and transposed cannot be viewed as
    pages: the route raises instead of writing a copy."""
    cfg = _cfg(64, 1)
    B, L, KV, hd = 2, 128, cfg.n_kv_heads, 64
    params, x, _ = _inputs(cfg, B, L, 1)
    cache = {n: torch.zeros((B, KV, L, hd)).transpose(1, 2)
             for n in ("k", "v")}
    with pytest.raises(RuntimeError, match="view"):
        attention.decode_attention(params, x, cfg, cache,
                                   torch.tensor([3, 9]))


def _models(name):
    kw = dict(reduced=True, head_dim=64)
    jcfg = jax_get_config(name, dtype=jnp.float32, param_dtype=jnp.float32,
                          **kw)
    tcfg = get_config(name, dtype=torch.float32, param_dtype=torch.float32,
                      **kw)
    init = jencdec.init_params if name == "whisper_large_v3" \
        else jlm.init_params
    jp = init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["paper_demo", "zamba2_1p2b"])
def test_decode_steps_on_the_route_match_jax(paged_calls, name):
    """Prefill of 37 tokens into a cache of 96 positions (pages of 32),
    then three decode steps: each step's logits and, after them, every
    layer's (dense) or site's (hybrid) KV cache against the reference's;
    the route runs at every attention layer of every step."""
    jcfg, tcfg, jp, tp = _models(name)
    toks = np.random.default_rng(4).integers(0, 512, (2, 37)).astype(
        np.int32)
    jl, jc = jlm.lm_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            jlm.init_cache(jcfg, 2, 96))
    tl, tc = lm.lm_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                           lm.init_cache(tcfg, 2, 96, device="cpu"))
    _close(tl, jl)
    for i in range(3):
        nxt = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jlm.lm_decode_step(jp, jnp.asarray(nxt), jcfg, jc,
                                    jnp.int32(37 + i))
        tl, tc = lm.lm_decode_step(tp, torch.from_numpy(nxt), tcfg, tc,
                                   37 + i)
        _close(tl, jl)
    sites = tcfg.hybrid_sites if name == "zamba2_1p2b" else tcfg.n_layers
    assert paged_calls == [32] * 3 * sites
    for name_ in ("k", "v"):
        want = np.stack([np.asarray(kv[name_]) for kv in jc["kv"]]) \
            if name == "zamba2_1p2b" else jc[name_]
        _close(tc[name_], want)


def test_enc_dec_decode_steps_on_the_route_match_jax(paged_calls):
    """whisper reduced at head_dim 64: its AUDIO prefill (a BOS at 0) and
    eight decode steps into a self-KV of 32 positions, each step's logits
    and the self-KV after it against the reference's step factories."""
    jcfg, tcfg, jp, tp = _models("whisper_large_v3")
    audio = np.random.default_rng(5).standard_normal((2, 24, 64)).astype(
        np.float32)
    jl, js = jax.jit(jsteps.make_prefill_step(jcfg, 32))(
        jp, {"audio_embed": jnp.asarray(audio)})
    tl, ts = make_prefill_step(tcfg, 32)(
        tp, {"audio_embed": torch.from_numpy(audio)})
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    tdec = make_decode_step(tcfg)
    for pos in range(1, 9):
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, js = jdec(jp, js, jnp.asarray(tok), jnp.int32(pos))
        tl, ts = tdec(tp, ts, torch.from_numpy(tok), pos)
        _close(tl, jl)
        for name in ("k", "v"):
            _close(ts["self"][name], js["self"][name])
    assert paged_calls == [32] * 9 * tcfg.n_dec_layers

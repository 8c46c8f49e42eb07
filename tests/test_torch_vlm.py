"""The port's VLM decoder (internvl2) against the JAX package on the CPU:
``internvl2_26b`` reduced (2 layers, d_model 128, 4/2 heads of head_dim 32,
16 patches of width 64, vocabulary 512), float32 with the reference's
weights carried over (``models.convert.params_from_numpy``) and held at
atol 1e-4 (ATOL).

The reference's ``ServeEngine`` builds for a VLM and fails at its first
admission (ROADMAP C.9), so the oracle is model-level: its ``lm_forward``
and ``lm_prefill`` with ``patches``, then ``lm_decode_step`` at
``n_patches + S`` onward. The port's engine refuses the family (and the
audio enc-dec) at construction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine, make_decode_step, make_prefill_step

ATOL = 1e-4
NAME = "internvl2_26b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODEL: list = []


def _model():
    """(jcfg, tcfg, jax params, port params) of reduced internvl2, built
    once per process."""
    if not _MODEL:
        jcfg = jax_get_config(NAME, reduced=True, dtype=jnp.float32,
                              param_dtype=jnp.float32)
        tcfg = get_config(NAME, reduced=True, dtype=torch.float32,
                          param_dtype=torch.float32)
        jp = jlm.init_params(jax.random.PRNGKey(2), jcfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               "cpu")
        _MODEL.extend((jcfg, tcfg, jp, tp))
    return _MODEL


def _inputs(seed, B, S, cfg):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal(
        (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return tokens, patches


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_config_and_param_count_match_reference():
    for reduced in (False, True):
        t = get_config("internvl2-26b", reduced=reduced)
        j = jax_get_config(NAME, reduced=reduced)
        assert (t.n_layers, t.d_model, t.padded_heads, t.padded_kv_heads,
                t.resolved_head_dim, t.d_ff, t.padded_vocab, t.frontend_dim,
                t.n_patches, t.tied_embeddings, t.rope_theta) == (
            j.n_layers, j.d_model, j.padded_heads, j.padded_kv_heads,
            j.resolved_head_dim, j.d_ff, j.padded_vocab, j.frontend_dim,
            j.n_patches, j.tied_embeddings, j.rope_theta)
        assert t.param_count() == j.param_count()


def test_init_params_has_the_patch_projector():
    _, tcfg, _, _ = _model()
    p = lm.init_params(tcfg, seed=0, device="cpu")
    assert tuple(p["frontend"]["proj"].shape) == (tcfg.frontend_dim,
                                                  tcfg.d_model)
    dense = lm.init_params(get_config("paper_demo", reduced=True), 0, "cpu")
    assert "frontend" not in dense


@pytest.mark.parametrize("S", [5, 24])
def test_forward_with_patches_matches_jax(S):
    jcfg, tcfg, jp, tp = _model()
    tokens, patches = _inputs(S, 2, S, tcfg)
    want = jlm.lm_forward(jp, {"tokens": jnp.asarray(tokens),
                               "patches": jnp.asarray(patches)}, jcfg)
    got = lm.lm_forward(tp, {"tokens": torch.from_numpy(tokens),
                             "patches": torch.from_numpy(patches)}, tcfg)
    assert got.shape == (2, tcfg.n_patches + S, tcfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_at_n_patches_plus_s_match_jax():
    """``lm_prefill`` with patches (logits and the primed cache, patch rows
    first), then 8 ``lm_decode_step``s at ``n_patches + S + i``, each
    against the reference's, the reference's greedy token fed to both."""
    jcfg, tcfg, jp, tp = _model()
    B, S, max_len = 2, 11, 40
    tokens, patches = _inputs(3, B, S, tcfg)
    jl, jc = jax.jit(lambda p, b, c: jlm.lm_prefill(p, b, jcfg, c))(
        jp, {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)},
        jlm.init_cache(jcfg, B, max_len))
    tl, tc = make_prefill_step(tcfg, max_len)(
        tp, {"tokens": torch.from_numpy(tokens),
             "patches": torch.from_numpy(patches)})
    _close(tl, jl)
    n = tcfg.n_patches + S
    _close(tc["k"][:, :, :n], jc["k"][:, :, :n])
    jdec = jax.jit(lambda p, t, c, pos: jlm.lm_decode_step(p, t, jcfg, c,
                                                           pos))
    tdec = make_decode_step(tcfg)
    for i in range(8):
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jdec(jp, jnp.asarray(tok), jc, jnp.int32(n + i))
        tl, tc = tdec(tp, tc, torch.from_numpy(tok), n + i)
        _close(tl, jl)
        _close(tc["v"][:, :, n + i], jc["v"][:, :, n + i])


def test_decode_after_patches_matches_forward():
    """The port against itself: prefill with patches and 6 decode steps
    equal ``lm_forward`` over patches, prompt and generated tokens."""
    _, tcfg, _, tp = _model()
    S, steps = 9, 6
    tokens, patches = _inputs(4, 1, S, tcfg)
    t_tok, t_pat = torch.from_numpy(tokens), torch.from_numpy(patches)
    logits, cache = make_prefill_step(tcfg, tcfg.n_patches + S + steps)(
        tp, {"tokens": t_tok, "patches": t_pat})
    seq, got = t_tok, [logits[:, -1]]
    for i in range(steps):
        nxt = torch.argmax(got[-1], dim=-1).to(torch.int32)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = lm.lm_decode_step(tp, nxt, tcfg, cache,
                                          tcfg.n_patches + S + i)
        got.append(logits[:, -1])
    full = lm.lm_forward(tp, {"tokens": seq[:, :-1], "patches": t_pat}, tcfg)
    _close(torch.stack(got, 1)[:, :steps], full[:, tcfg.n_patches + S - 1:])


def test_serve_engine_refuses_vlm_and_audio():
    _, tcfg, _, tp = _model()
    with pytest.raises(NotImplementedError, match="patches"):
        ServeEngine(tcfg, tp, device="cpu")
    wcfg = get_config("whisper_large_v3", reduced=True)
    with pytest.raises(NotImplementedError, match="audio enc-dec"):
        ServeEngine(wcfg, {}, device="cpu")


def test_require_ported_admits_vlm_and_refuses_audio():
    _, tcfg, _, _ = _model()
    lm.require_ported(tcfg)
    with pytest.raises(NotImplementedError, match="encdec"):
        lm.require_ported(get_config("whisper_large_v3"))
    with pytest.raises(NotImplementedError, match="encdec"):
        lm.init_params(get_config("whisper_large_v3", reduced=True), 0,
                       "cpu")


def test_converter_checks_the_frontend():
    jcfg, tcfg, jp, _ = _model()
    tree = jax.tree_util.tree_map(np.asarray, jp)
    bad = dict(tree)
    bad["frontend"] = {"proj": tree["frontend"]["proj"][:, :64]}
    with pytest.raises(ValueError, match="frontend"):
        params_from_numpy(bad, tcfg, "cpu")
    del bad["frontend"]
    with pytest.raises(ValueError, match="frontend"):
        params_from_numpy(bad, tcfg, "cpu")

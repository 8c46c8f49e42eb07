"""The port's hybrid family (zamba2) against the JAX package on the CPU:
``zamba2_1p2b`` reduced (d_model 128, 16 SSD heads of head_dim 16, state
16, chunk 32; the shared attention block at width 256, 4/2 heads of
head_dim 32, before every 2nd SSM layer) at 4 and 5 layers, float32 with
the reference's weights carried over (``models.convert.params_from_numpy``)
and held at atol 1e-4 (ATOL).

At 5 layers the shared block has 3 sites but the reference makes 5 // 2 =
2 projectors: its third site reads ``proj[2]``, which JAX clamps to
``proj[1]`` (ROADMAP C.7). The port has one projector per site and the
converter repeats the reference's last one, which is the function the
reference computes: the 5-layer cases show it.

Also here: the SSD scan at zamba2's (head_dim, state) = (64, 64), plain
version and the CUDA kernel's decomposition, against the JAX reference's
``ssd_chunked``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ssd_scan import ref as ssd_ref
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.serve import steps as jsteps
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (Request, RequestState, ServeEngine,
                               greedy_generate)

ATOL = 1e-4
MARGIN = 1e-3      # top-2 logit gap below which greedy tokens may flip
NAME = "zamba2_1p2b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS: dict = {}


def _model(n_layers):
    """(jcfg, tcfg, jax params, port params) of reduced zamba2 at
    ``n_layers``, built once per process."""
    if n_layers not in _MODELS:
        jcfg = jax_get_config(NAME, reduced=True, dtype=jnp.float32,
                              param_dtype=jnp.float32, n_layers=n_layers)
        tcfg = get_config(NAME, reduced=True, dtype=torch.float32,
                          param_dtype=torch.float32, n_layers=n_layers)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               "cpu")
        _MODELS[n_layers] = (jcfg, tcfg, jp, tp)
    return _MODELS[n_layers]


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


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax_but_counts_a_projector_per_site(reduced):
    """Every field and derived property as the reference's; the parameter
    count has one 2d x d projector per shared-block site, ceil(L / every),
    where the reference counts L // every."""
    j = jax_get_config(NAME, reduced=reduced)
    t = get_config(NAME, reduced=reduced)
    assert NAME in ARCHITECTURES
    for f in dataclasses.fields(jcommon.ModelConfig):
        if f.name not in ("dtype", "param_dtype", "ssm"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
    for prop in ("padded_heads", "padded_kv_heads", "resolved_head_dim",
                 "ssm_inner", "ssm_heads"):
        assert getattr(t, prop) == getattr(j, prop), prop
    extra = t.hybrid_sites - t.n_layers // t.hybrid_attn_every
    assert t.param_count() == j.param_count() \
        + extra * 2 * t.d_model * t.d_model
    if not reduced:
        assert (t.hybrid_sites, extra) == (7, 1)
        assert get_config(t.name) == t
        assert t.param_count() == 1_264_160_512     # 1.26 B


@pytest.mark.parametrize("n_layers", [4, 5])
def test_converter_gives_one_projector_per_site(n_layers):
    """4 layers: 2 sites, 2 projectors in both packages. 5 layers: 3 sites,
    the reference's 2 projectors and a copy of its last; the port's own
    ``init_params`` makes 3, and the leaves are the reference's."""
    jcfg, tcfg, jp, tp = _model(n_layers)
    jproj = np.asarray(jp["shared"]["proj"])
    assert jproj.shape[0] == n_layers // 2
    proj = tp["shared"]["proj"].numpy()
    assert proj.shape[0] == tcfg.hybrid_sites == -(-n_layers // 2)
    np.testing.assert_array_equal(proj[:jproj.shape[0]], jproj)
    np.testing.assert_array_equal(proj[jproj.shape[0]:], np.broadcast_to(
        jproj[-1], proj[jproj.shape[0]:].shape))
    ours = lm.init_params(tcfg, seed=1, device="cpu")
    want = jax.tree_util.tree_map(np.asarray, jp)
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_o) == len(flat_w)
    for path, t in flat_o:
        want_shape = tuple(proj.shape) if path[-1].key == "proj" \
            else flat_w[path].shape
        assert tuple(t.shape) == want_shape, path


def test_converter_refuses_another_projector_count():
    jcfg, tcfg, jp, _ = _model(5)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tree["shared"]["proj"] = tree["shared"]["proj"][:1]
    with pytest.raises(ValueError, match="projectors"):
        params_from_numpy(tree, tcfg, "cpu")


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("n_layers", [4, 5])
def test_lm_forward_matches_jax(n_layers):
    jcfg, tcfg, jp, tp = _model(n_layers)
    toks = _tokens(3, (2, 70))
    got = lm.lm_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    want = jlm.lm_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    _close(got, want)


@pytest.mark.parametrize("n_layers,S", [(4, 37), (5, 64)])
def test_prefill_and_decode_match_jax(n_layers, S):
    """Prefill then four decode steps: logits, every layer's SSM and conv
    state and every site's KV cache against the reference's per-layer and
    per-site lists."""
    jcfg, tcfg, jp, tp = _model(n_layers)
    toks = _tokens(4, (2, S))
    jc = jlm.init_cache(jcfg, 2, 96)
    jl, jc = jlm.lm_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jc)
    tc = lm.init_cache(tcfg, 2, 96, device="cpu")
    assert tc["k"].shape == (tcfg.hybrid_sites, 2, 96, 2, 32)
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
    for i, layer in enumerate(jc["ssm"]):
        for name, t in layer.items():
            _close(tc[name][i], t)
    for site, kv in enumerate(jc["kv"]):
        for name in ("k", "v"):
            _close(tc[name][site], kv[name])


def test_per_row_decode_equals_rows_decoded_alone():
    """One decode of a 3-row batch with the rows at positions 9, 70 and 33
    gives each row's logits and cache rows as decoding it alone."""
    _, tcfg, _, tp = _model(5)
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
        for name in cache:
            _close(cache[name][:, b], rows[name][:, 0])


def test_paged_decode_refuses_the_hybrid():
    _, tcfg, _, tp = _model(4)
    with pytest.raises(NotImplementedError, match="KV attention"):
        lm.lm_paged_decode(tp, torch.zeros((1, 1), dtype=torch.int32), tcfg,
                           {}, torch.zeros(1, dtype=torch.int32),
                           torch.zeros((1, 1), dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32), page_size=4)


# ------------------------------------------------------------------- serve
@pytest.mark.parametrize("n_layers", [4, 5])
def test_dense_engine_matches_jax_greedy(n_layers):
    """The engine in dense mode (chosen automatically: a hybrid has no
    paged cache), its slots at their own positions, against both
    ``greedy_generate`` oracles up to the first near tie."""
    jcfg, tcfg, jp, tp = _model(n_layers)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n) for n in (5, 37, 64, 20)]
    n_new = 10
    eng = ServeEngine(tcfg, tp, device="cpu", max_batch=3, max_cache_len=96)
    assert not eng.paged and eng._dense_kv
    reqs = [Request(p, n_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    assert all(r.req_state is RequestState.FINISHED for r in reqs)
    assert eng.idle and eng.stats["max_active"] == 3
    eng.shutdown()
    checked = 0
    for p, r in zip(prompts, reqs):
        theirs = np.asarray(jsteps.greedy_generate(
            jcfg, jp, jnp.asarray(p[None], jnp.int32), n_new, 96))[0]
        ours = greedy_generate(tcfg, tp, p[None], n_new, 96,
                               device="cpu")[0].tolist()
        n = _near_tie_prefix(jcfg, jp, p, theirs)
        assert r.tokens[:n] == ours[:n] == theirs[:n].tolist()
        checked += n
    assert checked >= len(prompts) * n_new // 2


def test_dense_engine_bounds_a_request_at_the_cache():
    _, tcfg, _, tp = _model(4)
    eng = ServeEngine(tcfg, tp, device="cpu", max_cache_len=48)
    with pytest.raises(ValueError, match="dense cache"):
        eng.submit(Request(_tokens(1, 30), 19))
    eng.submit(Request(_tokens(1, 30), 18))
    eng.shutdown()


# ---------------------------------------------------- SSD at (64, 64)
def _zamba2_ssd_inputs(T, H=64, P=64, N=64):
    """zamba2-1.2b's SSD widths (64 heads of head_dim 64, one group of
    state 64) at B = 1, inputs drawn as on the card
    (``chip_smoke.ssd_inputs``)."""
    rng = np.random.default_rng(T)
    x = 0.5 * rng.normal(size=(1, T, H, P))
    dt = np.log1p(np.exp(0.5 * rng.normal(size=(1, T, H)) - 3))
    A = -np.linspace(1.0, 16.0, H)
    Bm = rng.normal(size=(1, T, 1, N)) * N ** -0.25
    Cm = rng.normal(size=(1, T, 1, N)) * N ** -0.25
    D = 1 + 0.1 * rng.normal(size=H)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("T", [64, 200])
def test_ssd_at_zamba2_shape_matches_jax(T, bf16):
    """At (P, N) = (64, 64), H = 64: the plain version and the CUDA
    kernel's decomposition (with its bf16 operand rounding) against the
    JAX reference's plain ``ssd_chunked``: y within 1e-4 (fp32) or 2e-2
    (bf16), the fp32 final state within 1e-4."""
    assert (64, 64) in ssd.SHAPES
    f32 = _zamba2_ssd_inputs(T)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else \
        (torch.float32, jnp.float32)
    targs = [torch.from_numpy(a) for a in f32]
    jargs = [jnp.asarray(a) for a in f32]
    for i in (0, 3, 4):              # x, B and C in the working dtype
        targs[i] = targs[i].to(tdt)
        jargs[i] = jargs[i].astype(jdt)
    y, state = ssd.ssd_scan(*targs, return_state=True)
    y_k, state_k = ssd._ssd_chunk_parallel_plain(
        *targs, return_state=True,
        rounding=ssd.KERNEL_ROUNDING if bf16 else None)
    # the JAX side needs a chunk that divides T
    chunk = ssd.CHUNK if T % ssd.CHUNK == 0 else 40
    want_y, want_state = ssd_ref.ssd_chunked(*jargs, chunk=chunk)
    y_tol = 2e-2 if bf16 else 1e-4
    assert np.abs(y.float().numpy()).max() < 4
    for got in (y, y_k):
        _close(got.float(), np.asarray(want_y, np.float32), y_tol)
    for got in (state, state_k):
        _close(got, np.asarray(want_state), 1e-4)

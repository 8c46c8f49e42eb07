"""The port's training path against the JAX package on the CPU: the loss
(``layers.cross_entropy``, ``lm.lm_loss``, ``encdec.encdec_loss``) and its
gradients, the plain backward versions of the two backward kernels,
rematerialisation, AdamW, clipping, the schedules, ``make_train_step``
and the CPU trainer.

Reduced configs in float32 with the reference's weights carried over
(``models.convert``). Gradients are held leaf by leaf to
``jax.value_and_grad`` at rtol 1e-4 / atol 1e-5; train-step params at the
reference's own microbatching bound (atol 5e-5 / rtol 1e-4,
``tests/train/test_train_step.py``): AdamW's first steps divide by
sqrt(v) of one or two gradients, which scales a gradient's rounding up to
the update's size. The plain backward versions are held to ``jax.vjp``
of the JAX ``ref`` functions at 1e-5 (both in fp32 from the same inputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import ref as jattn_ref
from repro.kernels.rmsnorm import ref as jrms_ref
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro.optim import clip as jclip
from repro.optim import schedules as jsched
from repro.train import train_step as jtrain
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import rmsnorm as rms
from repro_torch.launch.train import train
from repro_torch.models import encdec, layers, lm
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.optim import (OptConfig, adamw_init, adamw_update,
                               clip_by_global_norm, constant, warmup_cosine)
from repro_torch.optim.tree import tree_leaves, tree_map
from repro_torch.train.train_step import (default_loss_fn, init_train_state,
                                          make_train_step)

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
STEP_RTOL, STEP_ATOL = 1e-4, 5e-5
VJP_ATOL = 1e-5
LM_CONFIGS = ("paper_demo", "mamba2_370m", "qwen3_moe_235b_a22b",
              "zamba2_1p2b", "internvl2_26b", "h2o_danube3_4b")
#: overrides of a reduced config in the gradient test: danube's window
#: cut below the batch's 32 positions, so that the window masks keys
LM_OVERRIDES = {"h2o_danube3_4b": {"window": 8}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS: dict = {}


def _model(name, **overrides):
    """(jcfg, tcfg, jax params, port params) of reduced ``name`` in fp32,
    built once per process."""
    key = (name, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        jcfg = jax_get_config(name, reduced=True, dtype=jnp.float32,
                              param_dtype=jnp.float32, **overrides)
        tcfg = get_config(name, reduced=True, dtype=torch.float32,
                          param_dtype=torch.float32, **overrides)
        init = jencdec.init_params if name.startswith("whisper") \
            else jlm.init_params
        jp = init(jax.random.PRNGKey(3), jcfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               "cpu")
        _MODELS[key] = (jcfg, tcfg, jp, tp)
    return _MODELS[key]


def _batch(cfg, seed, B=2, S=32):
    """A numpy batch of ``cfg``'s family: tokens (and a VLM's patches, an
    enc-dec's frames and decoder tokens)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend_dim and cfg.n_enc_layers:
        return {"audio_embed": rng.standard_normal(
                    (B, 24, cfg.frontend_dim)).astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(loss_fn, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    watched = tree_map(lambda _: next(it), params)
    loss = loss_fn(watched, batch)
    return loss, torch.autograd.grad(loss, leaves)


def _close_trees(got_leaves, want_tree, rtol, atol):
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        np.testing.assert_allclose(np.asarray(g.detach(), np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol)


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    logits[..., 45:] = -1e30            # a padded vocabulary's tail
    labels = rng.integers(0, 45, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.7).astype(np.float32) if masked else None
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_lm_loss_and_grads_match_jax(name):
    jcfg, tcfg, jp, tp = _model(name, **LM_OVERRIDES.get(name, {}))
    batch = _batch(tcfg, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, jcfg)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(lambda p, b: lm.lm_loss(p, b, tcfg), tp,
                         _torch_batch(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=GRAD_RTOL)
    _close_trees(grads, jgrads, GRAD_RTOL, GRAD_ATOL)


def test_encdec_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _model("whisper_large_v3")
    batch = _batch(tcfg, seed=2)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jencdec.encdec_loss(p, b, jcfg)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(lambda p, b: encdec.encdec_loss(p, b, tcfg), tp,
                         _torch_batch(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=GRAD_RTOL)
    _close_trees(grads, jgrads, GRAD_RTOL, GRAD_ATOL)


def test_default_loss_fn_picks_the_family_loss():
    jcfg, tcfg, jp, tp = _model("whisper_large_v3")
    batch = _torch_batch(_batch(tcfg, seed=2))
    assert float(default_loss_fn(tcfg)(tp, batch)) == float(
        encdec.encdec_loss(tp, batch, tcfg))
    _, dcfg, _, dp = _model("paper_demo")
    batch = _torch_batch(_batch(dcfg, seed=2))
    assert float(default_loss_fn(dcfg)(dp, batch)) == float(
        lm.lm_loss(dp, batch, dcfg))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_equal_none(policy):
    """Rematerialised layers give the loss and gradients of ``"none"``:
    the backward recomputes the same ops on the same inputs."""
    _, tcfg, _, tp = _model("paper_demo")
    batch = _torch_batch(_batch(tcfg, seed=4))
    ref_loss, ref = _grads(lambda p, b: lm.lm_loss(p, b, tcfg), tp, batch)
    rcfg = dataclasses.replace(tcfg, remat=policy)
    loss, got = _grads(lambda p, b: lm.lm_loss(p, b, rcfg), tp, batch)
    assert float(loss.detach()) == float(ref_loss.detach())
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)


def test_unknown_remat_policy_raises():
    _, tcfg, _, tp = _model("paper_demo")
    with pytest.raises(ValueError, match="remat"):
        lm.lm_loss(tp, _torch_batch(_batch(tcfg, 0)),
                   dataclasses.replace(tcfg, remat="most"))


# -------------------------------------------------- plain backward versions
def test_rmsnorm_backward_plain_matches_jax_vjp():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 9, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((3, 9, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s: jrms_ref.rmsnorm(a, s, 1e-5),
                     jnp.asarray(x), jnp.asarray(scale))
    wdx, wds = vjp(jnp.asarray(dy))
    dx, ds = rms.rmsnorm_backward_plain(torch.from_numpy(x),
                                        torch.from_numpy(scale),
                                        torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(wdx), atol=VJP_ATOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(wds), atol=VJP_ATOL,
                               rtol=1e-6)


ATTN_CASES = {
    "causal": dict(Sq=40, Sk=40, H=4, KV=4, causal=True),
    "gqa": dict(Sq=40, Sk=40, H=6, KV=2, causal=True),
    "window": dict(Sq=48, Sk=48, H=4, KV=2, causal=True, window=9),
    "q_offset": dict(Sq=12, Sk=40, H=4, KV=2, causal=True, q_offset=28),
    "noncausal": dict(Sq=17, Sk=30, H=4, KV=2, causal=False),
    "gqa7": dict(Sq=24, Sk=24, H=14, KV=2, causal=True),
}
#: head_dims of the plain backward's cases: a small one, and the backward
#: kernel's 120 (h2o-danube3) and 128 (zamba2's shared block and the dense
#: and MoE configs); the small one keeps each case's bare name
ATTN_DIMS = (16, 120, 128)


@pytest.mark.parametrize("case,D", [
    pytest.param(case, D, id=case if D == 16 else f"{case}-d{D}")
    for case in sorted(ATTN_CASES) for D in ATTN_DIMS])
def test_attention_backward_plain_matches_jax_vjp(case, D):
    c = dict(ATTN_CASES[case])
    Sq, Sk, H, KV = c.pop("Sq"), c.pop("Sk"), c.pop("H"), c.pop("KV")
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, D)).astype(np.float32)
    do = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    want = jax.jit(lambda a, b, w, g: jax.vjp(
        lambda a, b, w: jattn_ref.attention(a, b, w, **c), a, b, w)[1](g))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    o = flash.attention_plain(tq, tk, tv, **c)
    lse = flash.attention_lse_plain(tq, tk, **c)
    got = flash.attention_backward_plain(tq, tk, tv, o, lse,
                                         torch.from_numpy(do), **c)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=VJP_ATOL)
    # the log-sum-exp normalises each row's visible probabilities
    s = torch.einsum("bqhd,bkhd->bhqk", tq,
                     tk.repeat_interleave(H // KV, dim=2)) * D ** -0.5
    mask = flash._mask(Sq, Sk, c.get("causal", True), c.get("window", 0),
                       c.get("q_offset", 0), tq.device)
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones_like(lse))


@pytest.mark.parametrize("case,splits", [("gqa", 3), ("gqa7", 7),
                                         ("window", 2), ("q_offset", 2)])
def test_attention_backward_split_order_matches_jax_vjp(case, splits):
    """The backward kernel's dK/dV grid split over a group's query heads
    (``backward_splits``), its partial sums added in split order, against
    the unsplit plain version and ``jax.vjp`` of the reference."""
    c = dict(ATTN_CASES[case])
    Sq, Sk, H, KV = c.pop("Sq"), c.pop("Sk"), c.pop("H"), c.pop("KV")
    D = 16
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, D)).astype(np.float32)
    do = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    want = jax.jit(lambda a, b, w, g: jax.vjp(
        lambda a, b, w: jattn_ref.attention(a, b, w, **c), a, b, w)[1](g))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    o = flash.attention_plain(tq, tk, tv, **c)
    lse = flash.attention_lse_plain(tq, tk, **c)
    got = flash._attention_backward_split_plain(tq, tk, tv, o, lse, tdo,
                                                splits, **c)
    whole = flash.attention_backward_plain(tq, tk, tv, o, lse, tdo, **c)
    for g, p, w in zip(got, whole, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_backward_splits_fill_two_waves():
    """The dK/dV grid is split only below two waves of the card's SMs, by
    the smallest divisor of the group that reaches them."""
    assert flash.backward_splits(8, 1024, 12, 4) == 1    # 512 blocks
    assert flash.backward_splits(1, 1024, 64, 8) == 4    # 128 -> 512
    assert flash.backward_splits(1, 1024, 64, 4) == 8    # 64 -> 512
    assert flash.backward_splits(1, 1024, 48, 8) == 3    # 128 -> 384
    assert flash.backward_splits(1, 64, 4, 4) == 1       # G 1: no split
    assert flash.backward_splits(1, 64, 6, 2) == 3       # the whole group


def test_attention_lse_of_a_row_that_sees_no_key_is_inf():
    q = torch.randn(1, 4, 2, 8)
    k = torch.randn(1, 6, 2, 8)
    lse = flash.attention_lse_plain(q, k, causal=True, q_offset=-2)
    assert torch.isinf(lse[..., :2]).all()
    assert torch.isfinite(lse[..., 2:]).all()
    o = flash.attention_plain(q, k, k, causal=True, q_offset=-2)
    dq, dk, dv = flash.attention_backward_plain(
        q, k, k, o, lse, torch.randn_like(o), causal=True, q_offset=-2)
    assert torch.isfinite(dq).all() and (dq[:, :2] == 0).all()
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


# --------------------------------------------------------------- optimizer
def _np_tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _to_torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_adamw_updates_match_reference():
    shapes = {"w": (5, 7), "b": (7,), "s": ()}
    jopt, opt = JOptConfig(lr=1e-2), OptConfig(lr=1e-2)
    jp = {k: jnp.asarray(v) for k, v in _np_tree(0, shapes).items()}
    tp = _to_torch(_np_tree(0, shapes))
    jstate, tstate = jadamw.adamw_init(jp, jopt), adamw_init(tp, opt)
    for i in range(3):
        g = _np_tree(10 + i, shapes)
        lr = 1e-2 * (i + 1) / 3
        jp, jstate = jadamw.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp,
            jnp.float32(lr), jopt)
        tp, tstate = adamw_update(_to_torch(g), tstate, tp,
                                  torch.tensor(lr, dtype=torch.float32), opt)
    assert int(tstate["count"]) == int(jstate["count"]) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        for name in ("m", "v"):
            np.testing.assert_allclose(tstate[name][k].numpy(),
                                       np.asarray(jstate[name][k]),
                                       rtol=1e-6, atol=1e-9)


def test_adamw_update_leaves_its_inputs_as_they_were():
    tp = _to_torch(_np_tree(0, {"w": (4, 4)}))
    keep = tp["w"].clone()
    state = adamw_init(tp, OptConfig())
    new, new_state = adamw_update(_to_torch(_np_tree(1, {"w": (4, 4)})),
                                  state, tp, 1e-2, OptConfig())
    assert torch.equal(tp["w"], keep) and not torch.equal(new["w"], keep)
    assert int(state["count"]) == 0 and int(new_state["count"]) == 1
    assert float(state["m"]["w"].abs().sum()) == 0.0


def test_adamw_bf16_state_matches_reference():
    shapes = {"w": (6, 3)}
    jopt = JOptConfig(state_dtype=jnp.bfloat16)
    opt = OptConfig(state_dtype=torch.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in _np_tree(2, shapes).items()}
    tp = _to_torch(_np_tree(2, shapes))
    jstate, tstate = jadamw.adamw_init(jp, jopt), adamw_init(tp, opt)
    assert tstate["m"]["w"].dtype == torch.bfloat16
    g = _np_tree(3, shapes)
    jp, jstate = jadamw.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                     jstate, jp, jnp.float32(1e-3), jopt)
    tp, tstate = adamw_update(_to_torch(g), tstate, tp,
                              torch.tensor(1e-3), opt)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tstate["v"]["w"].float().numpy(),
                               np.asarray(jstate["v"]["w"], np.float32),
                               rtol=1e-2)


@pytest.mark.parametrize("max_norm", [1e9, 0.5])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _np_tree(4, {"a": (3, 5), "b": (5,)})
    jclipped, jnorm = jclip.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    clipped, norm = clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(jclipped[k]), rtol=1e-6)


def test_lr_schedule_shapes():
    """The reference's ``test_lr_schedule_shapes`` values, and the
    reference's schedule at every step of a short run."""
    sched = warmup_cosine(1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(sched(torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < 1e-3
    assert lrs[4] == pytest.approx(1e-4, rel=1e-2)
    jsched_fn = jsched.warmup_cosine(1e-3, warmup_steps=10, total_steps=100)
    for s in range(0, 120, 7):
        assert float(sched(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(jsched_fn(jnp.int32(s))), rel=1e-6, abs=1e-12)
    c = constant(3e-4)(torch.tensor(5, dtype=torch.int32))
    assert c.dtype == torch.float32 and float(c) == float(
        jsched.constant(3e-4)(jnp.int32(5)))


# -------------------------------------------------------------- train step
def _states(seed=0, **opt_kw):
    """The reference's initial train state and the port's, carried over."""
    jcfg, tcfg, _, _ = _model("paper_demo")
    jopt, opt = JOptConfig(**opt_kw), OptConfig(**opt_kw)
    jstate = jtrain.init_train_state(jax.random.PRNGKey(seed), jcfg, jopt)
    tstate = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), tcfg, "cpu")
    return jcfg, tcfg, jopt, opt, jstate, tstate


def test_train_state_from_numpy_carries_the_whole_state():
    jcfg, tcfg, _, opt, jstate, tstate = _states()
    assert sorted(tstate) == ["opt", "params", "step"]
    assert sorted(tstate["opt"]) == ["count", "m", "v"]
    assert tstate["step"].dtype == torch.int32 and tstate["step"].dim() == 0
    _close_trees(tree_leaves(tstate), jstate, 0, 0)
    fresh = init_train_state(tcfg, opt, seed=0, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(fresh)] == \
        [tuple(t.shape) for t in tree_leaves(tstate)]


def test_three_train_steps_match_reference():
    jcfg, tcfg, jopt, opt, jstate, tstate = _states(lr=1e-3)
    jsched_fn = jsched.warmup_cosine(1e-3, 1, 10)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt, lr_schedule=jsched_fn))
    tstep = make_train_step(tcfg, opt,
                            lr_schedule=warmup_cosine(1e-3, 1, 10))
    for i in range(3):
        batch = _batch(tcfg, seed=20 + i, B=4, S=32)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _torch_batch(batch))
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4)
    assert int(tstate["step"]) == 3
    _close_trees(tree_leaves(tstate["params"]), jstate["params"], STEP_RTOL,
                 STEP_ATOL)


def test_microbatching_matches_single_batch():
    """Four microbatches accumulate to one batch's update (the reference's
    test, on the port)."""
    _, tcfg, _, _ = _model("paper_demo")
    opt = OptConfig(lr=1e-3, grad_clip=1e9)
    state = init_train_state(tcfg, opt, seed=0, device="cpu")
    batch = _torch_batch(_batch(tcfg, seed=2, B=8, S=32))
    s1, m1 = make_train_step(tcfg, opt)(state, batch)
    s4, m4 = make_train_step(tcfg, opt, num_microbatches=4)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=STEP_ATOL,
                                   rtol=STEP_RTOL)


def test_grad_clip_reports_the_raw_norm():
    _, tcfg, _, _ = _model("paper_demo")
    opt = OptConfig(lr=1e-3, grad_clip=1e-4)
    state = init_train_state(tcfg, opt, seed=0, device="cpu")
    _, metrics = make_train_step(tcfg, opt)(
        state, _torch_batch(_batch(tcfg, seed=3)))
    assert float(metrics["grad_norm"]) > 1e-4


def test_cpu_trainer_loss_falls(tmp_path):
    """``launch.train`` on the CPU: six steps of reduced paper_demo with a
    checkpoint every three; the loss falls and the last save commits."""
    out = train("paper_demo", steps=6, global_batch=4, seq_len=32, lr=3e-3,
                reduced=True, ckpt_dir=str(tmp_path), ckpt_every=3,
                device="cpu", log_every=100)
    assert [r["step"] for r in out["rows"]] == list(range(6))
    assert out["final_loss"] < out["first_loss"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step-00000003", "step-00000006"]
    assert out["loss_ops"] == 6

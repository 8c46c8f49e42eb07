"""granite-4.0-h-small, the port's moe_hybrid family, on the CPU at its
reduced size (4 layers: three Mamba-2 and one attention, a whole period;
8 experts, top-3, a shared expert) against the benchmark's plain fp32
model of the family (``perfbench/families/moe_hybrid.py``, which imports
nothing of the port), on weights that model's module draws from a seed in
the port's layout.

Tolerances. Both sides compute in fp32 and differ only in the order of
their sums (the chunked SSD scan against the closed form, flash and the
dense decode against full scores, grouped products against a loop over
the experts): the largest gap seen on the logits (5e-3 at their
largest, std 1.2e-3) is 4.4e-9, so ``LOGITS_ATOL`` 1e-7 keeps 20x room;
the same model in bf16 reads 1.2e-3, 12,000 times over it
(``test_bf16_fails_the_fp32_tolerance``). Outputs of one block (about 1
at their largest) are held to ``BLOCK_ATOL`` 1e-5, the same ulps at that
scale.

The card test holds ``torch._grouped_mm`` (the dropless block's grouped
products on the card) to the plain loop in bf16, and the block to its
replay in a CUDA graph; it skips without a card.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import families  # noqa: E402
from perfbench.reference.model import build, forward_logits  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm, moe, ssm  # noqa: E402

NAME = "granite_4_0_h_small"
SEED = 2 ** 31 + 11
LOGITS_ATOL = 1e-7
BLOCK_ATOL = 1e-5


def _family():
    return families.module("moe_hybrid")


def _cfg(dtype=torch.float32):
    return get_config(NAME, reduced=True, dtype=dtype, param_dtype=dtype)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    cfg = _cfg()
    return cfg, _family().make_params(cfg, SEED, "cpu"), \
        build(_family().sizes(cfg))


def _tokens(n, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 512, (batch, n)), dtype=torch.int64)


def _tree(t, pre=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_tree(v, f"{pre}{k}."))
        else:
            out[pre + k] = (tuple(v.shape), v.dtype)
    return out


# ------------------------------------------------------------------ config
def test_param_count_at_the_published_sizes():
    cfg = get_config(NAME)
    assert cfg.param_count() == 32_207_337_984
    assert cfg.active_param_count() == 8_803_121_664
    m = _family().sizes(cfg)
    assert sum(_family().leaves(m).values()) == cfg.param_count()
    assert _family().flops_params(m) == cfg.active_param_count()
    p = lm.init_params(cfg, device="meta")
    assert sum(int(np.prod(shape)) for shape, _ in _tree(p).values()) \
        == cfg.param_count()


def test_the_config_is_the_published_one():
    cfg = get_config("granite-4.0-h-small")
    assert get_config(cfg.name) == cfg
    assert [i for i, (k, _) in enumerate(cfg.mixers) if k == "attention"] \
        == [5, 15, 25, 35]
    assert (cfg.n_mixers("mamba"), cfg.ssm_heads, cfg.padded_vocab) == \
        (36, 128, 100352)
    assert cfg.attn_scale == 1 / 128 and cfg.rope_theta == 0
    assert cfg.moe.dispatch == "dropless"
    red = _cfg()
    assert red.layer_types.count("attention") == 1 and red.n_layers == 4
    assert (red.moe.n_experts, red.moe.top_k) == (8, 3)


def test_the_family_draws_the_ports_layout():
    cfg = _cfg(torch.bfloat16)
    assert _tree(_family().make_params(cfg, SEED, "cpu")) == \
        _tree(lm.init_params(cfg, device="cpu"))


# ------------------------------------------------------------------- model
def test_forward_logits_match_the_reference(model):
    cfg, params, ref = model
    toks = _tokens(70, batch=2)
    want = forward_logits(ref, params, toks, 0)
    got = lm.lm_forward(params, {"tokens": toks}, cfg)
    torch.testing.assert_close(got, want, atol=LOGITS_ATOL, rtol=0)


def test_bf16_fails_the_fp32_tolerance(model):
    _, params, ref = model
    cfg = _cfg(torch.bfloat16)
    toks = _tokens(70)
    want = forward_logits(ref, params, toks, 0)
    half = _family().make_params(cfg, SEED, "cpu")
    got = lm.lm_forward(half, {"tokens": toks}, cfg).float()
    assert (got - want).abs().max() > 100 * LOGITS_ATOL


def test_prefill_then_dense_decode_matches_the_reference(model):
    """Two slots of a dense-mode cache: each prefilled alone into its rows
    at its own length, then decoded together, each at its own position (a
    device tensor, as the engine steps them)."""
    cfg, params, ref = model
    lens, steps = (13, 6), 9
    seqs = [_tokens(n + steps, seed=i)[0] for i, n in enumerate(lens)]
    cache = lm.init_cache(cfg, 2, 32, device="cpu")
    got = [[] for _ in lens]
    for i, n in enumerate(lens):
        views = {k: t[:, i:i + 1] for k, t in cache.items()}
        lg, _ = lm.lm_prefill(params, {"tokens": seqs[i][None, :n]}, cfg,
                              views)
        got[i].append(lg[0, -1])
    pos = torch.tensor(lens)
    for s in range(steps - 1):
        tok = torch.stack([seqs[i][n + s] for i, n in enumerate(lens)])
        lg, _ = lm.lm_decode_step(params, tok[:, None], cfg, cache, pos)
        for i in range(2):
            got[i].append(lg[i, -1])
        pos = pos + 1
    for i, n in enumerate(lens):
        want = forward_logits(ref, params, seqs[i][None], n - 1)[0]
        torch.testing.assert_close(torch.stack(got[i]), want[:steps],
                                   atol=LOGITS_ATOL, rtol=0)


def test_lm_loss_matches_the_reference(model):
    cfg, params, ref = model
    toks = _tokens(48, batch=2)
    with torch.no_grad():
        want = ref.loss(params, toks)
    got = lm.lm_loss(params, {"tokens": toks}, cfg)
    assert abs(float(got) - float(want)) <= 1e-6


# ---------------------------------------------------------------- mixers
def test_conv_bias_in_prefill_and_decode(model):
    """The Mamba-2 mixer over 24 positions: the first 15 prefilled, the
    rest decoded from the state, against the reference's mixer; without
    the bias both ways are far off."""
    cfg, params, ref = model
    p = {k: v[0] for k, v in params["ssm"].items()}
    h = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    want = ref.mamba(p, h)

    def port(cfg_, p_):
        y, state = ssm.ssm_block(p_, h[:, :15], cfg_, return_state=True)
        ys = [y]
        for t in range(15, 24):
            ys.append(ssm.ssm_decode_step(p_, h[:, t:t + 1], cfg_, state)[0])
        return torch.cat(ys, dim=1)
    torch.testing.assert_close(port(cfg, p), want, atol=BLOCK_ATOL, rtol=0)
    unbiased = dataclasses.replace(cfg, conv_bias=False)
    far = (port(unbiased, p) - want).abs()
    assert far[:, :15].max() > 100 * BLOCK_ATOL      # prefill
    assert far[:, 15:].max() > 100 * BLOCK_ATOL      # decode


# -------------------------------------------------------------------- MoE
def _uneven(cfg, params, tokens=16):
    """Layer 0's MoE block and inputs routed unevenly: expert 2's router
    column pulled toward the inputs, so every token picks it."""
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()}) for k, v in
         params["layers"]["moe"].items()}
    x = torch.randn(2, tokens // 2, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    p["router"] = p["router"].clone()
    p["router"][:, 2] += 2.0 * x.reshape(-1, cfg.d_model).mean(0)
    return p, x


def test_dropless_block_matches_a_per_token_loop(model):
    cfg, params, ref = model
    p, x = _uneven(cfg, params)
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    xf = x.reshape(T, -1)
    top, idx = torch.topk(xf @ p["router"], m.top_k, dim=-1)
    # expert 2 takes every token: more than a capacity-1.25 group holds
    assert int((idx == 2).sum()) == T
    assert T > moe.expert_capacity(cfg, T)
    gate = torch.softmax(top, dim=-1)

    def swiglu(w, t):
        return (torch.nn.functional.silu(t @ w["wg"]) * (t @ w["wi"])) \
            @ w["wo"]
    want = torch.stack([
        sum(gate[t, j] * swiglu({n: p[n][int(idx[t, j])]
                                 for n in ("wi", "wg", "wo")}, xf[t])
            for j in range(m.top_k)) + swiglu(p["shared"], xf[t])
        for t in range(T)]).view_as(x)
    got = moe.moe_block(p, x, cfg)
    torch.testing.assert_close(got, want, atol=BLOCK_ATOL, rtol=0)
    assert torch.equal(got, moe.moe_block(p, x, cfg))   # deterministic
    # the capacity modes drop some of the same assignments
    dropping = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, dispatch="scatter"))
    assert (moe.moe_block(p, x, dropping) - want).abs().max() > \
        100 * BLOCK_ATOL


def test_dropless_block_counts_calls_rows_and_experts(model):
    cfg, params, _ = model
    p, x = _uneven(cfg, params)
    counts = torch.zeros(3, dtype=torch.int64)
    moe.moe_block(p, x, cfg, counts)
    moe.moe_block(p, x[:1, :1], cfg, counts)
    moe.moe_block(p, x, cfg)                        # not counted
    T = x.shape[0] * x.shape[1]
    hit = len(set(torch.topk(x.reshape(T, -1) @ p["router"], 3)[1]
                  .flatten().tolist()))
    assert counts.tolist() == [2, 3 * T + 3, hit + 3]


# ------------------------------------------------------------ the engine
def test_the_engine_serves_it_in_dense_mode_with_its_counters(model):
    from perfbench.reference.check import widest_gaps
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.request import Request
    cfg, params, ref = model
    eng = ServeEngine(cfg, params, device="cpu", max_batch=3,
                      max_cache_len=64)
    assert not eng.paged
    rng = np.random.default_rng(3)
    reqs = [Request(rng.integers(0, 512, n).astype(np.int32), m)
            for n, m in ((10, 8), (5, 12), (20, 1), (7, 6))]
    for r in reqs:
        eng.submit(r)
    eng.close_intake()
    eng.run(timeout=120)
    gaps = widest_gaps(_family().sizes(cfg), params,
                       [(r.prompt, r.tokens) for r in reqs], "cpu")
    assert gaps["served"] <= LOGITS_ATOL
    s, L, k = eng.stats, cfg.n_layers, cfg.moe.top_k
    assert s["moe.decode.calls"] == L * s["steps"]
    assert s["moe.decode.rows"] == s["moe.decode.calls"] * 3 * k
    assert s["moe.decode.calls"] <= s["moe.decode.experts_hit"] <= \
        s["moe.decode.calls"] * cfg.moe.n_experts
    assert s["moe.prefill.calls"] == L * s["prefills"]
    assert s["moe.prefill.rows"] == L * k * sum(len(r.prompt) for r in reqs)


def test_the_cell_runs_through_the_harness_and_an_altered_token_fails(
        monkeypatch):
    """The cell at the CPU's size through the whole harness: correct, with
    its counters read. Its limit is set for the published widths, whose
    logits spread 5.7 times wider than these (std 0.0067 against 0.0012):
    here a served token altered reads at least 5 times the sound run's
    widest gap."""
    from perfbench.testing import run_small
    res = run_small("granite-longctx", seconds=1.5, trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["metrics"]["moe_rows_per_expert.decode"]["value"] >= 1
    sound = res["checks"]["widest_gap"]["value"]
    from repro_torch.serve.request import Request
    deliver = Request.deliver

    def altered(self, toks):
        return deliver(self, [(int(t) + 1) % 512 for t in toks])
    monkeypatch.setattr(Request, "deliver", altered)
    assert run_small("granite-longctx")["checks"]["widest_gap"]["value"] \
        > 5 * sound


# -------------------------------------------------------------------- card
@pytest.mark.gpu
def test_grouped_products_and_the_block_on_the_card():
    """``torch._grouped_mm`` at granite's widths (d 4096, experts of 768)
    against the plain loop in bf16, with empty groups, and fp32 refused;
    the dropless block under sync debug mode "error", and replayed in a
    CUDA graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    E, d, ff = 72, 4096, 768
    w = (torch.randn(E, d, ff, generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    counts = torch.randint(0, 9, (E,), generator=gen, device="cuda")
    counts[::7] = 0
    ends = torch.cumsum(counts, 0).to(torch.int32)
    a = torch.randn(int(ends[-1]), d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    got = moe.grouped_mm(a, w, ends)
    want = torch.empty_like(got)
    start = 0
    for e, end in enumerate(ends.tolist()):
        want[start:end] = a[start:end] @ w[e]
        start = end
    # each row is one bf16 product of depth 4096 either way: the two
    # differ by the order of fp32 partial sums and one bf16 rounding
    torch.testing.assert_close(got.float(), want.float(), atol=0.02,
                               rtol=0.02)
    # no other dtype on the card: it would have taken a loop that reads
    # the offsets back
    with pytest.raises(TypeError):
        moe.grouped_mm(a.float(), w.float(), ends)
    cfg = get_config(NAME)
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in moe.init_moe(gen, cfg, 1, "cuda").items()}
    x = torch.randn(32, 1, d, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    eager = moe.moe_block(p, x, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = moe.moe_block(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(again, eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_block(p, x, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = torch.zeros(3, dtype=torch.int64, device="cuda")
    with torch.cuda.graph(graph):
        out = moe.moe_block(p, x, cfg, n)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert n.tolist()[:2] == [2, 2 * 32 * 10]

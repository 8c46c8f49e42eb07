"""Disaggregated prefill/decode serving in the port (``serve/disagg.py``)
against its own oracles on the CPU, in float32: the port's colocated
``ServeEngine`` and ``greedy_generate``, compared up to the first near tie
(top-2 logit margin < 1e-3) of the oracle's sequence. Also the page pool's
``export_page``/``import_page`` bit for bit against the JAX package's, and
a cross-check of token identity with the JAX package itself.

The scenarios are those of ``tests/serve/test_disagg.py``: pipelining,
per-tag accounting, the three cancel paths, decode-pool backpressure,
the single-token request, deadlines and ``ServeClient`` over the server,
with page-leak checks on both role pools. The tests marked ``gpu`` run
the same server on the card and skip elsewhere:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_disagg.py
"""
import dataclasses
import time

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
from repro_torch.kernels import paged_attention, rmsnorm
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (DisaggServer, GenerationConfig, PagePool,
                               Request, RequestState, ServeClient,
                               ServeEngine, greedy_generate, pages_for,
                               serve_requests, serve_requests_disagg)
from repro_torch.serve.disagg import CTRL_TAG, block_tag

MARGIN = 1e-3      # top-2 logit gap below which greedy tokens may flip
KW = dict(device="cpu", max_batch=2, max_cache_len=64, page_size=4,
          max_seq_len=48)

PROMPTS = [
    list(range(1, 12)),          # 11 tokens -> 3 pages @ page_size=4
    list(range(5, 14)),          # 9 tokens
    [2, 3, 4, 5, 6],             # 5 tokens
    list(range(7, 20)),          # 13 tokens -> 4 pages
]


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


def _tie_free(cfg, params, prompt, tokens):
    """Leading generated positions before the first near tie of the
    sequence ``prompt + tokens`` (teacher-forced, the port's forward)."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens)])
    dev = params["embed"]["tokens"].device
    logits = lm.lm_forward(params, {"tokens": torch.as_tensor(
        seq[None], dtype=torch.int32, device=dev)}, cfg)[0].float()
    steps = logits[len(prompt) - 1:len(prompt) - 1 + len(tokens)]
    top2 = torch.topk(steps, 2, dim=-1).values
    small = ((top2[:, 0] - top2[:, 1]) < MARGIN).nonzero()
    return len(tokens) if len(small) == 0 else int(small[0, 0])


def _colocated(cfg, params, prompts, n, **kw):
    kw = {**KW, **kw}
    reqs = serve_requests(cfg, params, [Request(p, n) for p in prompts],
                          timeout=300, **kw)
    return [list(r.tokens) for r in reqs]


def _assert_oracles(cfg, params, prompts, reqs, n, **colo_kw):
    """Every request finished and its tokens equal the colocated engine's
    and ``greedy_generate``'s up to the oracle's first near tie; at least
    half of all tokens were compared."""
    colo = _colocated(cfg, params, prompts, n, **colo_kw)
    checked = 0
    for p, r, c in zip(prompts, reqs, colo):
        assert r.req_state is RequestState.FINISHED
        want = greedy_generate(cfg, params, np.asarray(p)[None], n, 64,
                               device=params["embed"]["tokens"].device)
        want = want[0].tolist()
        k = _tie_free(cfg, params, p, want)
        assert r.tokens[:k] == c[:k] == want[:k], (p, r.tokens, c, want)
        checked += k
    assert checked >= len(prompts) * n // 2


def _serve(srv, reqs, timeout=300):
    try:
        for r in reqs:
            srv.submit(r)
        srv.close_intake()
        srv.run(timeout=timeout)
    finally:
        srv.shutdown()
    return reqs


def _drain(srv, timeout=60.0):
    t0 = time.monotonic()
    while not srv.idle:
        assert time.monotonic() - t0 < timeout, "disagg server stuck"
        if not srv.step():
            time.sleep(1e-4)


def _assert_no_leaks(srv):
    assert srv.decode.pool.pages_in_use == 0
    assert srv.prefill.pool.pages_in_use == 0


# ------------------------------------------------- page export / import
def _bits(x):
    """A pool tensor's raw bits, as numpy, whatever its dtype."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_import_bit_equal_to_reference_pool(dtype):
    jcfg = jax_get_config("paper_demo", reduced=True,
                          dtype=getattr(jnp, dtype))
    tcfg = get_config("paper_demo", reduced=True,
                      dtype=getattr(torch, dtype))
    ours, theirs = PagePool(tcfg, 6, 4, device="cpu"), jkv.PagePool(jcfg,
                                                                   6, 4)
    assert ours.page_nbytes == theirs.page_nbytes
    ours.ensure_arrays()
    theirs.ensure_arrays()
    rng = np.random.default_rng(0)
    shape = tuple(ours.arrays["k"].shape)
    assert shape == tuple(theirs.arrays["k"].shape)

    def pattern():
        x = rng.normal(size=shape).astype(np.float32)
        if dtype == "float32":
            return x
        # the bf16 bits of x (upper halves): both sides hold them exactly
        return (x.view(np.uint32) >> 16).astype(np.uint16).view(np.int16)

    for k in ("k", "v"):
        x = pattern()
        ours.arrays[k] = torch.from_numpy(x.copy()).view(tcfg.dtype)
        theirs.arrays[k] = jnp.asarray(
            x if dtype == "float32" else x.view(jnp.bfloat16))
    ptrs = {k: t.data_ptr() for k, t in ours.arrays.items()}
    for page in (0, 3, 5):
        got, want = ours.export_page(page), theirs.export_page(page)
        for k in ("k", "v"):
            assert got[k].shape == tuple(want[k].shape)
            assert got[k].is_contiguous()
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    # install page 3's contents into page 1 on both sides
    old = ours.export_page(1)
    theirs.export_page(1)
    ours.import_page(1, ours.export_page(3))
    theirs.import_page(1, theirs.export_page(3))
    for k in ("k", "v"):
        np.testing.assert_array_equal(_bits(ours.arrays[k]),
                                      _bits(theirs.arrays[k]))
        # in place: the pool's storage (what a step graph reads) is kept
        assert ours.arrays[k].data_ptr() == ptrs[k]
        # an export is a copy: the old contents survive the overwrite
        assert not np.array_equal(_bits(old[k]),
                                  _bits(ours.arrays[k][:, 1]))
    assert ours.stats["pages_exported"] == theirs.stats["pages_exported"]
    assert ours.stats["pages_imported"] == theirs.stats["pages_imported"] \
        == 1


def test_export_of_a_one_layer_pool_is_still_a_copy():
    """With one layer a page's slice is contiguous: the export must still
    be a fresh tensor, not a view into the pool."""
    cfg = dataclasses.replace(get_config("paper_demo", reduced=True,
                                         dtype=torch.float32), n_layers=1)
    pool = PagePool(cfg, 3, 4, device="cpu")
    pool.ensure_arrays()
    pool.arrays["k"].normal_()
    before = pool.export_page(2)["k"]
    want = before.clone()
    pool.import_page(2, {"k": torch.zeros_like(before),
                         "v": torch.zeros_like(before)})
    assert torch.equal(before, want)
    assert float(pool.arrays["k"][:, 2].abs().max()) == 0.0


# ------------------------------------------------------- token identity
@pytest.mark.parametrize("chunk_pages", [1, 2])
def test_disagg_matches_colocated_and_greedy(model, chunk_pages):
    _, tcfg, _, tp = model
    reqs = [Request(p, 8) for p in PROMPTS]
    srv = DisaggServer(tcfg, tp, chunk_pages=chunk_pages, **KW)
    try:
        for r in reqs:
            srv.submit(r)
        srv.close_intake()
        srv.run(timeout=300)
        _assert_no_leaks(srv)
        m = srv.metrics()
        assert m["finished"] == len(PROMPTS)
        assert m["blocks_shipped"] == sum(pages_for(len(p), 4)
                                          for p in PROMPTS)
        assert m["bytes_shipped_per_request"] > 0
        # the chunks of each prompt: ceil(pages / chunk_pages)
        assert srv.prefill.stats["chunks"] == sum(
            -(-pages_for(len(p), 4) // chunk_pages) for p in PROMPTS)
        assert srv.decode.pool.stats["pages_imported"] == m["blocks_shipped"]
    finally:
        srv.shutdown()
    _assert_oracles(tcfg, tp, PROMPTS, reqs, 8)


def test_disagg_matches_colocated_speculative(model):
    """The decode role runs the same verify steps as the colocated
    engine; speculation changes the schedule, never the tokens."""
    _, tcfg, _, tp = model
    prompts = PROMPTS + [[9, 4, 11] * 5]
    srv = DisaggServer(tcfg, tp, speculate=4, **KW)
    reqs = _serve(srv, [Request(p, 8) for p in prompts])
    assert srv.decode.stats["verify_steps"] > 0
    _assert_no_leaks(srv)
    _assert_oracles(tcfg, tp, prompts, reqs, 8, speculate=4)


def test_disagg_matches_colocated_on_prefix_hit_traffic(model):
    """Traffic where the colocated engine takes the prefix-cache suffix
    path (the second request reuses the first's prompt pages): the
    prefill role recomputes instead of sharing."""
    _, tcfg, _, tp = model
    base = list(range(30, 42))              # 12 tokens = 3 full pages
    prompts = [base + [50], base + [60, 61, 62]]
    eng = ServeEngine(tcfg, tp, paged=True, **KW)
    try:
        for p in prompts:
            eng.submit(Request(p, 6))
        eng.close_intake()
        eng.run(timeout=300)
        assert eng.pool.stats["prefix_hits"] > 0     # hit path exercised
    finally:
        eng.shutdown()
    srv = DisaggServer(tcfg, tp, **KW)
    reqs = _serve(srv, [Request(p, 6) for p in prompts])
    _assert_no_leaks(srv)
    _assert_oracles(tcfg, tp, prompts, reqs, 6)


def test_single_token_request_answered_at_prefill_role(model):
    """max_tokens=1 is answered entirely by the prefill role: no header,
    no KV shipped, no decode involvement."""
    _, tcfg, _, tp = model
    prompt = [3, 4, 5, 6]
    want = greedy_generate(tcfg, tp, np.asarray([prompt]), 1, 64,
                           device="cpu")[0].tolist()
    req = Request(prompt, 1)
    srv = DisaggServer(tcfg, tp, **KW)
    _serve(srv, [req])
    assert req.tokens == want == _colocated(tcfg, tp, [prompt], 1)[0]
    assert req in srv.prefill.retired
    assert srv.metrics()["blocks_shipped"] == 0
    assert srv.decode.ingest_stats["headers"] == 0
    _assert_no_leaks(srv)


@pytest.mark.parametrize("chunk_pages", [1, 2])
def test_disagg_tokens_equal_the_jax_package(model, chunk_pages):
    """The same prompts through the port's ``DisaggServer`` give the JAX
    package's greedy tokens, up to the first near tie. The JAX package's
    own serving engines are no oracle here: on these prompts, in float32,
    its ``DisaggServer`` and (more rarely) its colocated paged engine emit
    other tokens in some runs (a fault of the reference, ROADMAP C)."""
    jcfg, tcfg, jp, tp = model
    ours = serve_requests_disagg(tcfg, tp, [Request(p, 8) for p in PROMPTS],
                                 timeout=300, chunk_pages=chunk_pages, **KW)
    checked = 0
    for p, a in zip(PROMPTS, ours):
        want = np.asarray(jsteps.greedy_generate(
            jcfg, jp, jnp.asarray([p], jnp.int32), 8, 64))[0].tolist()
        n = _tie_free(tcfg, tp, p, want)
        assert a.tokens[:n] == want[:n]
        checked += n
    assert checked >= len(PROMPTS) * 8 // 2


# -------------------------------------------------- per-block pipelining
@pytest.mark.parametrize("chunk_pages", [1, 2])
def test_blocks_ship_before_prefill_finishes(model, chunk_pages):
    """The decode role installs the FIRST KV block before the prefill
    role finishes the last chunk: per-block pipelining, not a barrier at
    end-of-prompt."""
    _, tcfg, _, tp = model
    prompts = [p for p in PROMPTS if len(p) > 8]
    srv = DisaggServer(tcfg, tp, chunk_pages=chunk_pages, **KW)
    reqs = _serve(srv, [Request(p, 6) for p in prompts])
    ev = srv.events
    for r in reqs:
        first_install = ev.index(("install", r.req_id, 0))
        prefill_done = ev.index(("prefill_done", r.req_id))
        assert first_install < prefill_done, ev
        ships = [e[2] for e in ev if e[:2] == ("ship", r.req_id)]
        installs = [e[2] for e in ev if e[:2] == ("install", r.req_id)]
        assert ships == installs == list(range(len(installs)))
    _assert_no_leaks(srv)


def test_transport_per_tag_accounting(model):
    """KV bandwidth is observable per channel: each request's block tag
    carries exactly its prompt pages at page_nbytes each; control traffic
    stays on CTRL_TAG."""
    _, tcfg, _, tp = model
    prompts = (PROMPTS[0], PROMPTS[3])
    srv = DisaggServer(tcfg, tp, **KW)
    reqs = _serve(srv, [Request(p, 6) for p in prompts])
    stats = srv.transport.stats()
    page_nbytes = srv.prefill.pool.page_nbytes
    assert page_nbytes == srv.decode.pool.page_nbytes == 2 * tcfg.n_layers \
        * 4 * tcfg.padded_kv_heads * tcfg.resolved_head_dim * 4
    for r, prompt in zip(reqs, prompts):
        t = stats["per_tag"][block_tag(r.req_id)]
        n = pages_for(len(prompt), 4)
        assert t["sent_msgs"] == t["recvd_msgs"] == n
        assert t["sent_bytes"] == t["recvd_bytes"] == n * page_nbytes
    ctrl = stats["per_tag"][CTRL_TAG]
    # header + done per request, all matched by the standing recv
    assert ctrl["sent_msgs"] == ctrl["recvd_msgs"] == 2 * len(reqs)
    assert stats["sent_bytes"] >= srv.prefill.bytes_shipped
    assert srv.prefill.bytes_shipped == srv.metrics()["blocks_shipped"] \
        * page_nbytes
    _assert_no_leaks(srv)


# --------------------------------------------------------- cancel paths
def test_cancel_mid_prefill_releases_both_pools(model):
    """Cancel while chunks are still running: the prefill role aborts,
    the decode role cancels its outstanding block receives, and neither
    pool leaks a page."""
    _, tcfg, _, tp = model
    srv = DisaggServer(tcfg, tp, chunk_pages=1, **KW)
    try:
        req = Request(list(range(1, 14)), 8)      # 4 pages of prompt
        srv.submit(req)
        t0 = time.monotonic()
        while ("header", req.req_id) not in srv.events:
            assert time.monotonic() - t0 < 60
            srv.step()
        assert ("prefill_done", req.req_id) not in srv.events
        req.cancel()
        srv.close_intake()
        _drain(srv)
        assert req.req_state is RequestState.CANCELLED
        assert req.tokens == []
        assert ("abort", req.req_id) in srv.events
        _assert_no_leaks(srv)
        assert not srv.decode._landings and not srv.prefill._jobs
        assert srv.decode.cr_ingest.active_count == 0
    finally:
        srv.shutdown()


def test_cancel_mid_shipping_discards_remaining_blocks(model):
    """Cancel after at least one block landed but before seating: already
    installed blocks are discarded with the landing, in-flight receives
    cancel atomically, and both pools drain to zero."""
    _, tcfg, _, tp = model
    srv = DisaggServer(tcfg, tp, chunk_pages=1, **KW)
    try:
        req = Request(list(range(1, 14)), 8)
        srv.submit(req)
        t0 = time.monotonic()
        while ("install", req.req_id, 0) not in srv.events:
            assert time.monotonic() - t0 < 60
            srv.step()
        assert ("seat", req.req_id) not in srv.events
        req.cancel()
        srv.close_intake()
        _drain(srv)
        assert req.req_state is RequestState.CANCELLED
        assert srv.decode.ingest_stats["blocks_installed"] >= 1
        _assert_no_leaks(srv)
        assert not srv.decode._landings and not srv.prefill._jobs
        # no receive left dangling on the ingest CR
        assert srv.decode.cr_ingest.active_count == 0
    finally:
        srv.shutdown()


def test_cancel_while_queued_at_router(model):
    """A request cancelled before the prefill role ever activates it is
    dropped cleanly and everything drains."""
    _, tcfg, _, tp = model
    srv = DisaggServer(tcfg, tp, prefill_jobs=1, **KW)
    live = Request(PROMPTS[0], 6)
    queued = Request(PROMPTS[1], 6)
    try:
        srv.submit(live)
        srv.submit(queued)
        queued.cancel()                   # before any step routes it
        srv.close_intake()
        srv.run(timeout=300)
        assert live.req_state is RequestState.FINISHED
        assert queued.req_state is RequestState.CANCELLED
        assert not srv.decode._expected
        _assert_no_leaks(srv)
    finally:
        srv.shutdown()


def test_cancel_after_activation_before_a_chunk_unannounces(model):
    """Cancelled after routing, while the job waits for staging pages: the
    prefill role sends a zero-shipped abort, and the decode role's
    expectation and both pools clear."""
    _, tcfg, _, tp = model
    # staging room for one 4-page prompt at a time
    srv = DisaggServer(tcfg, tp, prefill_pages=4, prefill_jobs=2, **KW)
    first = Request(PROMPTS[3], 6)
    second = Request(PROMPTS[0], 6)
    try:
        srv.submit(first)
        srv.submit(second)
        srv.step()                        # both routed, second deferred
        assert srv.prefill.stats["deferred"] >= 1
        second.cancel()
        srv.close_intake()
        srv.run(timeout=300)
        assert first.req_state is RequestState.FINISHED
        assert second.req_state is RequestState.CANCELLED
        assert not srv.decode._expected and not srv.decode._landings
        assert srv.decode.ingest_stats["aborts"] == 1
        _assert_no_leaks(srv)
    finally:
        srv.shutdown()


# ---------------------------------------------------------- backpressure
def test_decode_pool_backpressure_defers_landing(model):
    """A decode pool too small for two footprints at once: the second
    landing defers until the first retires, then completes — no deadlock,
    no leak, the oracles' tokens."""
    _, tcfg, _, tp = model
    prompts = [PROMPTS[0], PROMPTS[1]]
    # each request needs pages_for(plen + 6, 4) <= 5 pages; give the
    # decode pool room for one footprint plus a page, not two
    srv = DisaggServer(tcfg, tp, total_pages=6, **KW)
    reqs = _serve(srv, [Request(p, 6) for p in prompts])
    assert srv.decode.ingest_stats["landings_deferred"] >= 1
    _assert_no_leaks(srv)
    _assert_oracles(tcfg, tp, prompts, reqs, 6)


# ------------------------------------------------------- streaming front
def test_stream_client_over_disagg_server(model):
    """``ServeClient`` drives a ``DisaggServer`` through the same surface
    as a colocated engine: its streams carry the oracles' tokens."""
    _, tcfg, _, tp = model
    srv = DisaggServer(tcfg, tp, **KW)
    with ServeClient(engine=srv) as client:
        session = client.session(max_tokens=8)
        streams = [session.generate(p) for p in PROMPTS]
        got = [list(s) for s in streams]
        for s in streams:
            assert s.reason == "finished"
        assert client.metrics()["disaggregated"] is True
    _assert_no_leaks(srv)
    colo = _colocated(tcfg, tp, PROMPTS, 8)
    for p, g, c in zip(PROMPTS, got, colo):
        n = _tie_free(tcfg, tp, p, c)
        assert g[:n] == c[:n]


def test_disagg_respects_request_deadline(model):
    """A request whose deadline already passed at routing expires without
    prefill compute or page allocation at either role."""
    _, tcfg, _, tp = model
    doomed = Request(PROMPTS[0],
                     GenerationConfig(max_tokens=6, deadline_s=1e-6),
                     arrival_time=time.monotonic() - 1.0)
    live = Request(PROMPTS[2], 6)
    srv = DisaggServer(tcfg, tp, **KW)
    _serve(srv, [doomed, live])
    assert doomed.req_state is RequestState.EXPIRED
    assert live.req_state is RequestState.FINISHED
    assert srv.prefill.stats["jobs"] == 1       # doomed never started
    _assert_no_leaks(srv)


def test_stop_sequence_at_prefill_and_decode(model):
    """A stop sequence that completes on the first token retires at the
    prefill role; one that completes later retires at the decode role;
    both pools drain."""
    _, tcfg, _, tp = model
    p = PROMPTS[0]
    want = greedy_generate(tcfg, tp, np.asarray([p]), 6, 64,
                           device="cpu")[0].tolist()
    early = Request(p, GenerationConfig(max_tokens=6, stop=[want[:1]]))
    late = Request(p, GenerationConfig(max_tokens=6, stop=[want[2:4]]))
    srv = DisaggServer(tcfg, tp, **KW)
    _serve(srv, [early, late])
    assert early.tokens == [] and early in srv.prefill.retired
    assert late.tokens == want[:2] and late in srv.decode.retired
    _assert_no_leaks(srv)


def test_no_card_means_no_server(model):
    """The default device is the card: without one, construction raises
    (nothing falls back to the CPU)."""
    _, tcfg, _, tp = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DisaggServer(tcfg, tp)
    with pytest.raises(ValueError, match="paged-cache-capable"):
        DisaggServer(dataclasses.replace(tcfg, window=8), tp, device="cpu")


# --------------------------------------------------------------- the card
def _card_model(n_layers=2):
    """``paper_demo`` at full width (the kernels' head_dim 64), cut to
    ``n_layers``, in float32."""
    cfg = dataclasses.replace(
        get_config("paper_demo", dtype=torch.float32,
                   param_dtype=torch.float32), n_layers=n_layers)
    return cfg, lm.init_params(cfg, seed=0, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_pages,speculate", [(1, 0), (4, 0), (2, 3)])
def test_disagg_on_card_matches_greedy(chunk_pages, speculate):
    """On the card both roles launch the paged kernel (the prefill role's
    chunks, the decode role's graph replays), blocks install before
    prefill finishes, and the tokens are greedy's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _card_model()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (70, 33, 129)]
    srv = DisaggServer(cfg, params, max_batch=4, page_size=16,
                       max_seq_len=256, chunk_pages=chunk_pages,
                       speculate=speculate)
    graph = srv.decode._verify_graph if speculate \
        else srv.decode._decode_graph
    assert graph.graph is not None
    paged_attention.LAUNCHES = rmsnorm.LAUNCHES = 0
    reqs = _serve(srv, [Request(p, 20) for p in prompts], timeout=120)
    torch.cuda.synchronize()
    chunks = srv.prefill.stats["chunks"]
    assert chunks == sum(-(-pages_for(len(p), 16) // chunk_pages)
                         for p in prompts)
    assert paged_attention.LAUNCHES == cfg.n_layers * (
        chunks + srv.decode.stats["steps"])
    assert graph.replays == srv.decode.stats["steps"] > 0
    _assert_no_leaks(srv)
    for r in reqs:
        assert srv.events.index(("install", r.req_id, 0)) < \
            srv.events.index(("prefill_done", r.req_id))
    for p, r in zip(prompts, reqs):
        want = greedy_generate(cfg, params, p[None], 20, 256,
                               device="cuda")[0].tolist()
        n = _tie_free(cfg, params, p, want)
        assert r.tokens[:n] == want[:n]

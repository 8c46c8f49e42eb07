"""The port's CUDA kernels against their plain versions, on the card, and
the transport's device-tensor messages and the apps built on them.

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Elsewhere every test skips (the kernels have no CPU mode); the CPU tests
hold the plain versions against the JAX package instead.
"""
import time

import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import TensorOp, Transport
from repro_torch.core.transport import take
from repro_torch.dataflow import (ContinuationBackend, TestsomeBackend,
                                  assemble_result, build_cholesky_graph,
                                  make_spd_matrix, potrf_failures,
                                  run_dataflow)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.zones import distributed_solve, make_zones, reference_solve

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STATE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8, 768), (513, 768), (3, 64),
                                    (8, 1024),
                                    (5, 4096),    # longer than a lane caches
                                    # whisper's decode rows and one clip's
                                    # encoder rows, internvl2's decode rows
                                    (8, 1280), (1500, 1280), (8, 6144)])
def test_rmsnorm_kernel(cuda, dtype, rows, d):
    x = _randn(cuda, (rows, d), dtype)
    scale = 1 + 0.1 * torch.randn((d,), generator=cuda, device="cuda")
    n0 = rn.LAUNCHES
    out = rn.rmsnorm(x, scale)
    assert rn.LAUNCHES == n0 + 1
    err = (out.float() - rn.rmsnorm_plain(x, scale).float()).abs().max()
    assert float(err) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,H,KV,D,causal,window,q_offset", [
    (512, 512, 12, 4, 64, True, 0, 0),
    (200, 200, 12, 4, 64, True, 0, 0),
    (64, 100, 4, 2, 64, False, 0, 0),
    (96, 96, 4, 4, 64, True, 33, 0),
    (1, 77, 6, 2, 64, True, 0, 76),
    (1024, 1024, 12, 4, 64, True, 0, 0),     # max_seq_len, 64-row q tiles
    (100, 612, 12, 4, 64, True, 0, 512),     # a prompt chunk past 512 keys
    # the head dims of the other dense configs: 128 (deepseek-coder,
    # llama3, command-r) and 120 (h2o-danube3, sliding window)
    (512, 512, 32, 8, 128, True, 0, 0),
    (300, 300, 16, 1, 128, True, 0, 0),      # llama3's 16 q-heads a KV head
    (100, 612, 8, 2, 128, True, 0, 512),
    (333, 333, 32, 8, 120, True, 0, 0),
    (700, 700, 32, 8, 120, True, 256, 0),
    (64, 900, 8, 2, 120, True, 300, 836),    # a windowed chunk at an offset
])
def test_flash_attention_kernel(cuda, dtype, Sq, Sk, H, KV, D, causal,
                                window, q_offset):
    """B = 2 throughout; in bf16, grids under one block per SM take 32-row
    q tiles and larger ones 64-row tiles (both tensor-core paths)."""
    q = _randn(cuda, (2, Sq, H, D), dtype)
    k = _randn(cuda, (2, Sk, KV, D), dtype)
    v = _randn(cuda, (2, Sk, KV, D), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    n0 = fa.LAUNCHES
    out = fa.attention(q, k, v, **kw)
    assert fa.LAUNCHES == n0 + 1
    err = (out.float() - fa.attention_plain(q, k, v, **kw).float()).abs().max()
    assert float(err) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq", [(1, 1500), (8, 1)])
def test_flash_attention_non_causal_at_whisper_shapes(cuda, dtype, B, Sq):
    """whisper-large-v3's attention: 32/32 heads of head_dim 64 against
    its 1500 encoder frames, non-causal: the encoder (Sq = Sk) and a
    decode step's cross-attention (one query row a clip, 8 clips). 1500 is
    not a multiple of the 32-key tiles (the KV tail mask). Heads 20-31
    get all-zero K and V, as whisper's padded heads do: their rows must
    come out exactly zero."""
    q = _randn(cuda, (B, Sq, 32, 64), dtype)
    k = _randn(cuda, (B, 1500, 32, 64), dtype)
    v = _randn(cuda, (B, 1500, 32, 64), dtype)
    k[:, :, 20:] = 0
    v[:, :, 20:] = 0
    n0 = fa.LAUNCHES
    out = fa.attention(q, k, v, causal=False)
    assert fa.LAUNCHES == n0 + 1
    ref = fa.attention_plain(q, k, v, causal=False)
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype]
    assert bool((out[:, :, 20:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,positions,n_valid,shared", [
    (1, [17, 100, 255, 0], [1, 1, 1, 0], 0),
    (16, [256], [13], 0),
    (40, [32], [40], 0),
    # 8 slots at mixed positions up to T * ps - 1, one idle
    (1, [1023, 0, 64, 127, 500, 900, 17, 300], [1, 1, 1, 1, 1, 1, 1, 0], 0),
    # windows starting on a split boundary (64), ending on one, and one
    # straddling it (the kernel's splits are 64 positions)
    (2, [64, 126, 63], [2, 2, 2], 0),
    # a W=256 suffix over 16 prefix pages that both slots share
    (256, [256, 256], [250, 7], 16),
])
def test_paged_attention_kernel(cuda, dtype, W, positions, n_valid, shared):
    S, KV, G, hd, ps, T = len(positions), 4, 3, 64, 16, 64
    needs = [-(-(p + W) // ps) for p in positions]
    P = shared + sum(n - shared for n in needs) + 8   # 8 pages nobody names
    tables = torch.full((S, T), P, dtype=torch.int32)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(0))
    tables[:, :shared] = perm[:shared]
    nxt = shared
    for s in range(S):
        tables[s, shared:needs[s]] = perm[nxt:nxt + needs[s] - shared]
        nxt += needs[s] - shared
    args = [_randn(cuda, (S, W, KV * G, hd), dtype),
            _randn(cuda, (S, W, KV, hd), dtype),
            _randn(cuda, (S, W, KV, hd), dtype)]
    kp = _randn(cuda, (P + 1, ps, KV, hd), dtype)
    vp = _randn(cuda, (P + 1, ps, KV, hd), dtype)
    ints = [tables.cuda(), torch.tensor(positions, dtype=torch.int32).cuda(),
            torch.tensor(n_valid, dtype=torch.int32).cuda()]
    kk, vk, kq, vq = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    n0 = pa.LAUNCHES
    o, _, _ = pa.paged_attention(*args, kk, vk, *ints, page_size=ps)
    assert pa.LAUNCHES == n0 + 1
    ref, _, _ = pa.paged_attention_plain(*args, kq, vq, *ints, page_size=ps)
    assert float((o.float() - ref.float()).abs().max()) <= TOL[dtype]
    # pools bit-exact everywhere: neither version writes the null page
    assert torch.equal(kk, kq) and torch.equal(vk, vq)
    assert torch.equal(kk[P], kp[P]) and torch.equal(vk[P], vp[P])
    for s, n in enumerate(n_valid):
        if n == 0:
            assert bool((o[s] == 0).all()), "idle slot output not 0"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [8, 16])
@pytest.mark.parametrize("W,positions,n_valid", [
    (1, [17, 100, 255, 300, 511, 640, 1000, 0], [1] * 7 + [0]),
    (16, [256], [13]),
    (4, [62, 1019], [4, 4]),     # windows across a 64-position split
])
def test_paged_attention_kernel_at_head_dim_128(cuda, dtype, G, W, positions,
                                                n_valid):
    """head_dim 128 with deepseek's 8 (one a zero-weight pad head in the
    model) and llama3's 16 q-heads per KV head, 8 KV heads."""
    S, KV, hd, ps, T = len(positions), 8, 128, 16, 64
    needs = [-(-(p + W) // ps) for p in positions]
    P = sum(needs) + 4
    tables = torch.full((S, T), P, dtype=torch.int32)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(1))
    nxt = 0
    for s in range(S):
        tables[s, :needs[s]] = perm[nxt:nxt + needs[s]]
        nxt += needs[s]
    args = [_randn(cuda, (S, W, KV * G, hd), dtype),
            _randn(cuda, (S, W, KV, hd), dtype),
            _randn(cuda, (S, W, KV, hd), dtype)]
    kp = _randn(cuda, (P + 1, ps, KV, hd), dtype)
    vp = _randn(cuda, (P + 1, ps, KV, hd), dtype)
    ints = [tables.cuda(), torch.tensor(positions, dtype=torch.int32).cuda(),
            torch.tensor(n_valid, dtype=torch.int32).cuda()]
    kk, vk, kq, vq = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    n0 = pa.LAUNCHES
    o, _, _ = pa.paged_attention(*args, kk, vk, *ints, page_size=ps)
    assert pa.LAUNCHES == n0 + 1
    ref, _, _ = pa.paged_attention_plain(*args, kq, vq, *ints, page_size=ps)
    assert float((o.float() - ref.float()).abs().max()) <= TOL[dtype]
    assert torch.equal(kk, kq) and torch.equal(vk, vq)


def _zamba2(dtype=torch.bfloat16):
    from repro_torch.configs import get_config
    return get_config("zamba2_1p2b", dtype=dtype, param_dtype=dtype)


def test_dense_decode_route_at_the_zamba2_longctx_shape(cuda):
    """zamba2-longctx's attention site: 32 slots on a 4096-position bf16
    cache, 32/32 heads of 128 at the shared block's width 4096, slots at
    positions 1023 .. 4095 and one idle at the engine's idle position 0.
    The route (the paged kernel on the cache in place, one launch) against
    ``_grouped`` on the card: caches equal bit for bit, outputs within the
    bf16 tolerance. They differ by rounding: ``_grouped`` rounds the scores
    and probabilities to bf16 before the softmax and the PV product, the
    kernel keeps them in fp32 and sums its 64 splits' partials."""
    from repro_torch.models import attention
    cfg = _zamba2()
    B, L, width = 32, 4096, 2 * cfg.d_model
    KV, hd = cfg.padded_kv_heads, cfg.resolved_head_dim
    assert (cfg.padded_heads, KV, hd) == (32, 32, 128)
    params = attention.init_attention(cfg, cuda, "cuda", width=width)
    x = _randn(cuda, (B, 1, width), torch.bfloat16)
    pos = torch.linspace(1023, 4095, B - 1).long().tolist() + [0]
    pos = torch.tensor(pos, device="cuda")
    cache = {n: _randn(cuda, (B, L, KV, hd), torch.bfloat16)
             for n in ("k", "v")}
    ref_cache = {n: t.clone() for n, t in cache.items()}
    n0 = pa.LAUNCHES
    out, _ = attention.decode_attention(params, x, cfg, cache, pos)
    assert pa.LAUNCHES == n0 + 1
    qpos = pos[:, None]
    q, k, v = attention._project_qkv(params, x, cfg,
                                     attention._rope(cfg, qpos))
    attention._write_rows(ref_cache, k, v, qpos % L)
    valid = torch.arange(L, device="cuda")[None, None, :] <= qpos[:, :, None]
    ref = attention._out_proj(
        params, attention._grouped(q, ref_cache["k"], ref_cache["v"], valid,
                                   cfg), cfg)
    assert pa.LAUNCHES == n0 + 1
    assert torch.equal(cache["k"], ref_cache["k"])
    assert torch.equal(cache["v"], ref_cache["v"])
    err = float((out.float() - ref.float()).abs().max())
    assert err <= TOL[torch.bfloat16], err


def test_eager_zamba2_decode_step_launches_the_paged_kernel_at_each_site(
        cuda):
    """One eager ``lm_decode_step`` of zamba2-1.2b at full width launches
    the paged kernel once at each of its 7 shared-block sites (a graph
    replay adds the same count back without a Python call)."""
    from repro_torch.models import lm
    cfg = _zamba2()
    assert cfg.hybrid_sites == 7
    params = lm.init_params(cfg, seed=0, device="cuda")
    cache = lm.init_cache(cfg, 4, 256, device="cuda")
    token = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    pos = torch.tensor([0, 5, 100, 255], device="cuda")
    n0 = pa.LAUNCHES
    logits, _ = lm.lm_decode_step(params, token, cfg, cache, pos)
    assert pa.LAUNCHES == n0 + cfg.hybrid_sites
    assert bool(torch.isfinite(logits.float()).all())


def test_attention_kernels_refuse_uninstantiated_head_dims(cuda):
    """No fallback: a head_dim without an instantiation raises on CUDA
    tensors (96 for both; 120 for the paged kernel, which no paged config
    uses) and launches nothing."""
    f0, p0 = fa.LAUNCHES, pa.LAUNCHES
    q = _randn(cuda, (1, 8, 4, 96), torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        fa.attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    for hd in (96, 120):
        S, W, KV, ps, T = 1, 1, 2, 16, 2
        q = _randn(cuda, (S, W, 4, hd), torch.bfloat16)
        kn = _randn(cuda, (S, W, KV, hd), torch.bfloat16)
        pool = _randn(cuda, (3, ps, KV, hd), torch.bfloat16)
        i32 = dict(dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="hd in"):
            pa.paged_attention(q, kn, kn.clone(), pool, pool.clone(),
                               torch.zeros((S, T), **i32),
                               torch.zeros(S, **i32), torch.ones(S, **i32),
                               page_size=ps)
    assert (fa.LAUNCHES, pa.LAUNCHES) == (f0, p0)


def _ssd_inputs(gen, B, T, H, P, G, N, dtype):
    """Inputs shaped like mamba2's: dt ~ softplus(N(-3, 0.5)), A from
    -linspace(1, 16), |y| below 4 so one bf16 rounding step stays within
    the bf16 tolerance; D differs per head."""
    x = (0.5 * torch.randn((B, T, H, P), generator=gen, device="cuda")
         ).to(dtype)
    dt = F.softplus(0.5 * torch.randn((B, T, H), generator=gen,
                                      device="cuda") - 3)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm = (torch.randn((B, T, G, N), generator=gen, device="cuda")
          * N ** -0.25).to(dtype)
    Cm = (torch.randn((B, T, G, N), generator=gen, device="cuda")
          * N ** -0.25).to(dtype)
    D = 1 + 0.1 * torch.randn((H,), generator=gen, device="cuda")
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,G", [
    (1, 512, 1),      # mamba2-370m prefill of a 512-token prompt
    (1, 509, 1),      # a prime length: masked tail chunk
    (4, 256, 1),      # several sequences
    (2, 100, 4),      # groups, and a tail of 36 rows
    (1, 7, 1),        # shorter than one chunk
    (1, 64, 1),       # one chunk: 128 blocks a grid
    (1, 2048, 1),     # 32 chunks: a 33.5 MB scratch, past half the L2
])
def test_ssd_scan_kernel(cuda, dtype, B, T, G):
    args = _ssd_inputs(cuda, B, T, 32, 64, G, 128, dtype)
    n0 = ssd.LAUNCHES
    y, final = ssd.ssd_scan(*args, return_state=True)
    assert ssd.LAUNCHES == n0 + 1
    y_only = ssd.ssd_scan(*args)
    y_ref, final_ref = ssd.ssd_scan_plain(*args, return_state=True)
    assert y.dtype == dtype and final.dtype == torch.float32
    assert float((y.float() - y_ref.float()).abs().max()) <= TOL[dtype]
    # the state is fp32 on both sides, from the same inputs
    assert float((final - final_ref).abs().max()) <= STATE_TOL
    assert torch.equal(y, y_only)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T", [
    (1, 64),          # one chunk
    (1, 509),         # a prime length: masked tail chunk
    (1, 2048),        # zamba2's longest prompt in chip_smoke
    (3, 100),         # several sequences, a tail of 36 rows
])
def test_ssd_scan_kernel_at_zamba2_shape(cuda, dtype, B, T):
    """zamba2-1.2b's (head_dim, state) = (64, 64) over its 64 SSD heads:
    each warp of a chunk-state block owns 16 state columns."""
    args = _ssd_inputs(cuda, B, T, 64, 64, 1, 64, dtype)
    n0 = ssd.LAUNCHES
    y, final = ssd.ssd_scan(*args, return_state=True)
    assert ssd.LAUNCHES == n0 + 1
    y_ref, final_ref = ssd.ssd_scan_plain(*args, return_state=True)
    assert final.shape == (B, 64, 64, 64)
    assert float((y.float() - y_ref.float()).abs().max()) <= TOL[dtype]
    assert float((final - final_ref).abs().max()) <= STATE_TOL


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_block_captures_in_a_graph_without_host_reads(cuda, dispatch):
    """The MoE block reads nothing back and allocates nothing by data: it
    runs under sync debug mode "error" and in a CUDA graph, whose replay
    equals the eager block."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    # qwen3-moe's routing (128 experts, top-8) at a small width
    cfg = get_config("qwen3_moe_235b_a22b", reduced=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        get_config("qwen3_moe_235b_a22b").moe, d_ff=128, dispatch=dispatch))
    params = {k: v[0] for k, v in moe.init_moe(cuda, cfg, 1, "cuda").items()}
    # a prompt of 768 tokens (one group), then 8 slots' 5-row windows
    prompt = _randn(cuda, (1, 768, cfg.d_model), cfg.dtype)
    x = _randn(cuda, (8, 5, cfg.d_model), cfg.dtype)
    want = [moe.moe_block(params, t, cfg) for t in (prompt, x)]  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [moe.moe_block(params, t, cfg) for t in (prompt, x)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    want = want[1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_block(params, x, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.moe_block(params, x, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_scratch_reuse(cuda, dtype):
    """The wrapper's scratch comes from the caching allocator, holding
    what earlier calls (of other lengths) or other tensors left there:
    results must not depend on it."""
    shapes = [512, 2048, 64, 509]
    args = {T: _ssd_inputs(cuda, 1, T, 32, 64, 1, 128, dtype)
            for T in shapes}
    first = {T: ssd.ssd_scan(*args[T], return_state=True) for T in shapes}
    for T in reversed(shapes):
        # a freed block of the scratch's size, full of NaN
        del_me = torch.full((ssd.scratch_floats(1, T, 32, 64, 128),),
                            float("nan"), device="cuda")
        del del_me
        y, final = ssd.ssd_scan(*args[T], return_state=True)
        assert torch.equal(y, first[T][0]) and torch.equal(final,
                                                           first[T][1])


def test_ssd_scan_refuses_uninstantiated_sizes(cuda):
    x, dt, A, Bm, Cm, D = _ssd_inputs(cuda, 1, 64, 4, 32, 1, 16,
                                      torch.float32)
    n0 = ssd.LAUNCHES
    with pytest.raises(ValueError, match="no kernel for head_dim 32"):
        ssd.ssd_scan(x, dt, A, Bm, Cm, D)
    args = _ssd_inputs(cuda, 1, 64, 4, 64, 1, 128, torch.float32)
    with pytest.raises(ValueError, match="chunk 32"):
        ssd.ssd_scan(*args, chunk=32)
    assert ssd.LAUNCHES == n0


# ------------------------------------------- device-tensor messages
def _sleep_cycles(ms: float) -> int:
    """Clock cycles of ``torch.cuda._sleep`` that hold the card ``ms``."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    return int(ms * 10_000_000 / start.elapsed_time(end))


def test_transport_device_payload_waits_for_its_producer(cuda):
    """A payload written on a producer stream behind a sleep kernel: the
    receive completes only after the producer's work, the receiver's
    stream reads the right values, and nothing waits on the host."""
    cycles = _sleep_cycles(50.0)
    producer, consumer = torch.cuda.Stream(), torch.cuda.Stream()
    n = 1 << 20
    with torch.cuda.stream(producer):
        # allocated, and its kernels loaded, ahead: a cudaMalloc or a
        # kernel's first launch behind the sleep would wait for it
        x = torch.empty(n, device="cuda", dtype=torch.float64)
        torch.arange(n, out=x).mul_(2).sum()
    torch.cuda.synchronize()
    tr = Transport(2)
    recv = tr.irecv(1, source=0, tag=1)
    n0 = TensorOp.PENDING_AT_FIRST_POLL
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(producer):
            torch.cuda._sleep(cycles)
            torch.arange(n, out=x).mul_(2)
            written = torch.cuda.Event()
            written.record()
            send = tr.isend(0, 1, 1, ("tile", x))
        assert not recv.done() and not written.query()
        deadline = time.monotonic() + 10
        while not recv.done() and time.monotonic() < deadline:
            pass
        assert recv.done() and send.done()
        assert written.query()           # never before the producer's work
        with torch.cuda.stream(consumer):
            _, y = take(recv.status.payload)
            total = y.sum()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert TensorOp.PENDING_AT_FIRST_POLL > n0
    torch.cuda.synchronize()
    assert float(total) == float(n * (n - 1))


def test_transport_record_stream_keeps_a_freed_payload(cuda):
    """The sender drops its tensor right after the send and allocates
    again on its stream while the receiver's read is still queued behind
    a sleep: ``take`` keeps the block from being reused under the read."""
    cycles = _sleep_cycles(50.0)
    producer, consumer = torch.cuda.Stream(), torch.cuda.Stream()
    n = 1 << 22
    for stream in (producer, consumer):   # load the kernels ahead
        with torch.cuda.stream(stream):
            (torch.full((n,), 7.0, device="cuda") * 1.0).zero_()
    torch.cuda.synchronize()
    tr = Transport(2)
    recv = tr.irecv(1, source=0, tag=2)
    with torch.cuda.stream(producer):
        tr.isend(0, 1, 2, torch.full((n,), 7.0, device="cuda"))
    deadline = time.monotonic() + 10
    while not recv.done() and time.monotonic() < deadline:
        pass
    assert recv.done()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(consumer):
            torch.cuda._sleep(cycles)
            y = take(recv.status.payload)
            copy = y * 1.0               # queued behind the sleep
        recv.status.payload = None       # the last references go
        del y
        with torch.cuda.stream(producer):
            other = torch.zeros(n, device="cuda")   # same size, same stream
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool((copy == 7.0).all()) and bool((other == 0).all())


def test_transport_holds_a_kv_block_message_behind_its_writer(cuda):
    """A ``KVBlockMsg`` (a dataclass, its tensors in fields) exported
    behind a 50 ms sleep on the producer's stream is not matchable until
    the sleep and the export have run; then the consumer's stream reads
    the page."""
    from repro_torch.serve.disagg import KVBlockMsg
    cycles = _sleep_cycles(50.0)
    producer, consumer = torch.cuda.Stream(), torch.cuda.Stream()
    shape = (12, 16, 4, 64)
    with torch.cuda.stream(producer):
        # allocated, and the copy kernels loaded, ahead
        pool = torch.zeros((2,) + shape, device="cuda", dtype=torch.bfloat16)
        pool[1].clone()
        pool[1].fill_(3.0)
    torch.cuda.synchronize()
    tr = Transport(2)
    recv = tr.irecv(1, source=0, tag=5)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(producer):
            torch.cuda._sleep(cycles)
            pool[0].fill_(7.0)
            k, v = pool[0].clone(), pool[1].clone()
            send = tr.isend(0, 1, 5, KVBlockMsg(0, 0, k, v))
        del k, v
        assert tr.stats()["device_sends"] == 1
        assert tr.stats()["device_sends_pending"] == 1
        assert not recv.done() and not send.done()
        t0 = time.monotonic()
        deadline = t0 + 10
        while not recv.done() and time.monotonic() < deadline:
            pass
        waited = time.monotonic() - t0
        assert recv.done() and send.done()
        with torch.cuda.stream(consumer):
            msg = take(recv.status.payload)
            total = msg.k.float().sum() + msg.v.float().sum()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert waited > 0.02                 # held through most of the sleep
    torch.cuda.synchronize()
    assert float(total) == (7.0 + 3.0) * pool[0].numel()


def test_zones_on_card_bit_identical_to_cpu(cuda):
    want = reference_solve(make_zones(8, 64, 16, seed=3, device="cpu"), 4, 2)
    zones = make_zones(8, 64, 16, seed=3)
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(reference_solve(zones, 4, 2), want))
    for variant in ("fork_join", "continuations"):
        got, _ = distributed_solve(zones, 4, 4, variant, 2)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.parametrize("backend", ["continuations", "testsome"])
def test_cholesky_on_card(cuda, backend):
    A = make_spd_matrix(6 * 64, seed=5)
    graph, meta = build_cholesky_graph(A, 6, 64, 4)
    factory = (lambda eng: ContinuationBackend(eng)) \
        if backend == "continuations" else (lambda eng: TestsomeBackend(4))
    tiles, _ = run_dataflow(graph, factory, timeout=120)
    L = assemble_result(tiles, meta)
    want = torch.linalg.cholesky(A)
    assert float((L - want).abs().max() / want.abs().max()) <= 1e-10
    assert potrf_failures(meta) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whisper_decode_step_graph_bit_equal_to_eager(cuda, dtype):
    """whisper-large-v3 at full width, 2 encoder and 2 decoder layers: the
    decode step captured as a ``StepGraph`` over static token and position
    buffers gives, replay by replay, the eager step's logits and self-KV
    bit for bit, at per-row positions; each replay adds the step's
    launches back (flash once a layer, rmsnorm three times a layer and
    once more)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.serve import make_decode_step, make_prefill_step
    from repro_torch.serve.graphs import StepGraph
    cfg = dataclasses.replace(
        get_config("whisper_large_v3", dtype=dtype, param_dtype=dtype),
        n_enc_layers=2, n_dec_layers=2)
    params = encdec.init_params(cfg, seed=0, device="cuda")
    audio = torch.randn((3, 1500, cfg.frontend_dim), generator=cuda,
                        device="cuda")
    logits, state = make_prefill_step(cfg, 64)(params,
                                               {"audio_embed": audio})
    eager = {"cross": state["cross"],
             "self": {n: t.clone() for n, t in state["self"].items()}}
    decode = make_decode_step(cfg)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    pos = torch.tensor([1, 1, 1], device="cuda")
    tok_buf, pos_buf = tok.clone(), pos.clone()
    graph = StepGraph(lambda: decode(params, state, tok_buf, pos_buf)[0],
                      torch.device("cuda"))
    # the capture's warm-up wrote the position-1 rows: rewrite them below
    n_fa, n_rn = fa.LAUNCHES, rn.LAUNCHES
    for i in range(4):
        want, eager = decode(params, eager, tok, pos)
        tok_buf.copy_(tok)
        pos_buf.copy_(pos)
        got = graph()
        assert torch.equal(got, want)
        assert torch.equal(state["self"]["k"], eager["self"]["k"])
        tok = torch.argmax(want[:, -1], -1).to(torch.int32)[:, None]
        pos = pos + torch.tensor([1, 2, 3], device="cuda")
    L = cfg.n_dec_layers
    assert fa.LAUNCHES - n_fa == 2 * 4 * L
    assert rn.LAUNCHES - n_rn == 2 * 4 * (3 * L + 1)


# ------------------------------------------------------- backward kernels
def _grad_tol(dtype, plain):
    """The kernels' tolerance, scaled by the plain output's largest
    magnitude where that is above 1 (a dscale sums thousands of rows)."""
    return TOL[dtype] * max(1.0, float(plain.float().abs().max()))


# every config's width (768 to llama3's 16,384) at one row, 7 and 8193
CONFIG_WIDTHS = (768, 1024, 1280, 2048, 3840, 4096, 5120, 6144, 7168, 12288,
                 16384)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8192, 768),     # paper_demo's step
                                    (7, 768), (33, 1280), (100, 4096)]
                         + [(rows, d) for d in CONFIG_WIDTHS
                            for rows in (1, 7, 8193)])
def test_rmsnorm_backward_kernel(cuda, dtype, rows, d):
    x = _randn(cuda, (rows, d), dtype)
    scale = 1 + 0.1 * torch.randn((d,), generator=cuda, device="cuda")
    dy = _randn(cuda, (rows, d), dtype)
    n0 = rn.BACKWARD_LAUNCHES
    dx, ds = rn.rmsnorm_backward(x, scale, dy)
    assert rn.BACKWARD_LAUNCHES == n0 + 1
    px, ps = rn.rmsnorm_backward_plain(x, scale, dy)
    assert dx.dtype == dtype and ds.dtype == torch.float32
    assert float((dx.float() - px.float()).abs().max()) <= _grad_tol(dtype,
                                                                     px)
    assert float((ds - ps).abs().max()) <= _grad_tol(torch.float32, ps)
    # no atomics: a second call gives the same bits
    dx2, ds2 = rn.rmsnorm_backward(x, scale, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window,q_offset", [
    (8, 1024, 1024, 12, 4, True, 0, 0),      # paper_demo's training step
    (1, 300, 300, 4, 2, True, 70, 0),        # a window
    (2, 77, 131, 4, 4, False, 0, 0),         # non-causal, odd lengths
    (2, 100, 100, 6, 2, True, 0, 0),         # odd length, G = 3
    (1, 33, 200, 4, 2, True, 0, 167),        # a q_offset
])
def test_flash_attention_backward_kernel(cuda, dtype, B, Sq, Sk, H, KV,
                                         causal, window, q_offset):
    """The backward kernel against the plain backward in fp32 on the same
    inputs and the forward kernel's log-sum-exp (held to the plain one)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q = _randn(cuda, (B, Sq, H, 64), dtype)
    k = _randn(cuda, (B, Sk, KV, 64), dtype)
    v = _randn(cuda, (B, Sk, KV, 64), dtype)
    do = _randn(cuda, (B, Sq, H, 64), dtype)
    code = 0 if dtype is torch.float32 else 1
    o, lse = fa._launch(q, k, v, causal, window, q_offset, 0.125, code,
                        with_lse=True)
    plain_lse = fa.attention_lse_plain(q, k, **kw)
    assert float((lse - plain_lse).abs().max()) <= 1e-4
    n0 = fa.BACKWARD_LAUNCHES
    got = fa.attention_backward(q, k, v, o, lse, do, **kw)
    assert fa.BACKWARD_LAUNCHES == n0 + 1
    o32 = fa.attention_plain(q.float(), k.float(), v.float(), **kw)
    want = fa.attention_backward_plain(q.float(), k.float(), v.float(), o32,
                                       plain_lse, do.float(), **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert float((g.float() - w).abs().max()) <= _grad_tol(dtype, w)
    again = fa.attention_backward(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_autograd_takes_the_kernels_only_when_a_gradient_is_wanted(cuda):
    """With grad enabled and an input that requires it, the wrappers run
    the forward kernel (flash writing its log-sum-exp) and, in the
    backward, the backward kernel; the gradients equal autograd of the
    plain versions. Without, the forward alone, writing no log-sum-exp:
    serving's launches are unchanged."""
    from repro_torch.kernels import _build
    lib = _build.lib()
    real = lib.repro_flash_attention
    lse_args = []

    def spy(*args):
        lse_args.append(args[5])
        return real(*args)

    x = _randn(cuda, (2, 100, 768), torch.float32)
    scale = 1 + 0.1 * torch.randn((768,), generator=cuda, device="cuda")
    q = _randn(cuda, (2, 100, 12, 64), torch.float32)
    k = _randn(cuda, (2, 100, 4, 64), torch.float32)
    v = _randn(cuda, (2, 100, 4, 64), torch.float32)
    lib.repro_flash_attention = spy
    try:
        counts = (rn.LAUNCHES, rn.BACKWARD_LAUNCHES, fa.LAUNCHES,
                  fa.BACKWARD_LAUNCHES)
        with torch.no_grad():
            rn.rmsnorm(x.requires_grad_(), scale)
            fa.attention(q.requires_grad_(), k, v)
        x.requires_grad_(False)
        q.requires_grad_(False)
        rn.rmsnorm(x, scale)
        fa.attention(q, k, v)
        assert (rn.LAUNCHES, rn.BACKWARD_LAUNCHES, fa.LAUNCHES,
                fa.BACKWARD_LAUNCHES) == (counts[0] + 2, counts[1],
                                          counts[2] + 2, counts[3])
        assert lse_args == [None, None]
        xs, ss, qs, ks, vs = (t.clone().requires_grad_()
                              for t in (x, scale, q, k, v))
        y = rn.rmsnorm(xs, ss)
        o = fa.attention(qs, ks, vs)
        assert lse_args[-1] is not None
        loss = (y * y).sum() + (o * o).sum()
        got = torch.autograd.grad(loss, (xs, ss, qs, ks, vs))
    finally:
        lib.repro_flash_attention = real
    assert (rn.BACKWARD_LAUNCHES, fa.BACKWARD_LAUNCHES) == (counts[1] + 1,
                                                            counts[3] + 1)
    xp, sp, qp, kp, vp = (t.clone().requires_grad_()
                          for t in (x, scale, q, k, v))
    loss = (rn.rmsnorm_plain(xp, sp) ** 2).sum() \
        + (fa.attention_plain(qp, kp, vp) ** 2).sum()
    want = torch.autograd.grad(loss, (xp, sp, qp, kp, vp))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= _grad_tol(torch.float32, w)


def test_autograd_refuses_a_gradient_no_kernel_gives(cuda):
    """No fallback: what no backward kernel computes raises at the forward
    and launches nothing (a head_dim with no kernel). The SSD scan's final
    state with grad now has one: ``_SSDFunction`` returns y and the final
    state, and the backward kernel takes both gradients (``dfinal``), as
    autograd of the plain version does."""
    f0, s0, b0 = fa.LAUNCHES, ssd.LAUNCHES, ssd.BACKWARD_LAUNCHES
    args = _ssd_inputs(cuda, 2, 100, 4, 64, 1, 128, torch.float32)
    watched = [t.clone().requires_grad_() for t in args]
    y, final = ssd.ssd_scan(*watched, return_state=True)
    assert ssd.LAUNCHES == s0 + 1
    dy = _randn(cuda, y.shape, torch.float32)
    dfinal = _randn(cuda, final.shape, torch.float32)
    got = torch.autograd.grad((y, final), watched, (dy, dfinal))
    assert ssd.BACKWARD_LAUNCHES == b0 + 1
    plain = [t.clone().requires_grad_() for t in args]
    py, pf = ssd.ssd_scan_plain(*plain, return_state=True)
    want = torch.autograd.grad((py, pf), plain, (dy, dfinal))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= _grad_tol(torch.float32, w)
    # the final state's gradient alone (y unused)
    y, final = ssd.ssd_scan(*watched, return_state=True)
    got = torch.autograd.grad(final, watched, dfinal)
    want = ssd.ssd_scan_backward_plain(*args, torch.zeros_like(dy), dfinal)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= _grad_tol(torch.float32, w)
    q = _randn(cuda, (1, 64, 8, 96), torch.bfloat16).requires_grad_()
    k = _randn(cuda, (1, 64, 2, 96), torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        fa.attention(q, k, k)
    assert fa.LAUNCHES == f0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,G,N", [
    (2, 1024, 32, 1, 128),   # mamba2-370m's training step, at B 2
    (1, 509, 32, 1, 128),    # a prime length: masked tail chunk
    (2, 100, 8, 2, 128),     # groups, and a tail of 36 rows
    (1, 7, 4, 1, 128),       # shorter than one chunk
    (2, 1024, 64, 1, 64),    # zamba2-1.2b's
    (1, 64, 64, 1, 64),      # one chunk
    # either side of the head-split rule's boundary (264 chunks fill two
    # waves of 132 SMs): 260 chunks split the group's 4 heads in two
    # slices, 264 take one
    (4, 4160, 4, 1, 128),
    (4, 4224, 4, 1, 128),
    (4, 4160, 4, 1, 64),
    (2, 700, 8, 2, 64),      # groups, split, N 64 and a tail
])
@pytest.mark.parametrize("with_dfinal", [False, True])
def test_ssd_scan_backward_kernel(cuda, dtype, B, T, H, G, N, with_dfinal):
    """The SSD backward kernel against the plain backward in fp32 on the
    same (dtype-valued) inputs, with and without the final state's
    gradient: each gradient within the tolerance of its largest
    magnitude, the same bits on a second call (no atomics)."""
    args = _ssd_inputs(cuda, B, T, H, 64, G, N, dtype)
    dy = _randn(cuda, (B, T, H, 64), dtype)
    dfinal = _randn(cuda, (B, H, 64, N), torch.float32) \
        if with_dfinal else None
    n0 = ssd.BACKWARD_LAUNCHES
    got = ssd.ssd_scan_backward(*args, dy, dfinal)
    assert ssd.BACKWARD_LAUNCHES == n0 + 1
    x, dt, A, Bm, Cm, D = args
    want = ssd.ssd_scan_backward_plain(x.float(), dt, A, Bm.float(),
                                       Cm.float(), D, dy.float(), dfinal)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert g.shape == w.shape, name
        assert g.dtype == (dtype if name in ("dx", "dB", "dC")
                           else torch.float32), name
        assert torch.isfinite(g).all(), name
        assert float((g.float() - w).abs().max()) <= _grad_tol(dtype, w), \
            name
    again = ssd.ssd_scan_backward(*args, dy, dfinal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_scan_autograd_takes_the_backward_kernel(cuda):
    """With grad wanted the wrapper runs ``_SSDFunction``: the gradients of
    all six inputs equal autograd of the plain version; without, the
    forward alone."""
    args = _ssd_inputs(cuda, 2, 200, 32, 64, 1, 128, torch.float32)
    dy = _randn(cuda, (2, 200, 32, 64), torch.float32)
    n0, b0 = ssd.LAUNCHES, ssd.BACKWARD_LAUNCHES
    watched = [t.clone().requires_grad_() for t in args]
    got = torch.autograd.grad(ssd.ssd_scan(*watched), watched, dy)
    assert (ssd.LAUNCHES, ssd.BACKWARD_LAUNCHES) == (n0 + 1, b0 + 1)
    plain = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ssd.ssd_scan_plain(*plain), plain, dy)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= _grad_tol(torch.float32, w)
    with torch.no_grad():
        ssd.ssd_scan(*watched)
    assert (ssd.LAUNCHES, ssd.BACKWARD_LAUNCHES) == (n0 + 2, b0 + 1)


def test_ssd_scan_autograd_under_checkpoint(cuda):
    """Under non-reentrant activation checkpointing (a train step's remat)
    the backward unpacks each saved tensor once: the gradients, through
    the final state too, equal those without checkpointing."""
    from torch.utils.checkpoint import checkpoint
    args = _ssd_inputs(cuda, 1, 130, 4, 64, 1, 128, torch.float32)
    dy = _randn(cuda, (1, 130, 4, 64), torch.float32)
    dfinal = _randn(cuda, (1, 4, 64, 128), torch.float32)

    def loss(*t):
        y, final = ssd.ssd_scan(*t, return_state=True)
        return (y * dy).sum() + (final * dfinal).sum()

    watched = [t.clone().requires_grad_() for t in args]
    got = torch.autograd.grad(checkpoint(loss, *watched, use_reentrant=False),
                              watched)
    want = torch.autograd.grad(loss(*watched), watched)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window", [
    (1, 700, 700, 32, 8, 120, True, 300),    # h2o-danube3 (hd 120), window
    (2, 256, 256, 32, 32, 128, True, 0),     # zamba2's shared block
    (1, 200, 200, 64, 4, 128, True, 0),      # qwen3-moe's G = 16
    (1, 150, 150, 56, 8, 128, True, 0),      # deepseek's G = 7
    (2, 77, 131, 8, 8, 120, False, 0),       # non-causal, odd lengths
    # a ragged key tail that cuts a 64-row TMA box, at both widths
    (1, 131, 131, 8, 2, 120, True, 0),
    (1, 131, 131, 8, 2, 128, True, 0),
    # the dK/dV grid splits the group's query heads (64 blocks, G 16:
    # 8 splits) and sums the partials in a second pass
    (1, 1024, 1024, 64, 4, 128, True, 0),
])
def test_flash_attention_backward_kernel_at_head_dims_120_and_128(
        cuda, dtype, B, Sq, Sk, H, KV, D, causal, window):
    """The backward kernel at head_dim 120 and 128 against the plain
    backward in fp32; a second call gives the same bits."""
    kw = dict(causal=causal, window=window)
    q = _randn(cuda, (B, Sq, H, D), dtype)
    k = _randn(cuda, (B, Sk, KV, D), dtype)
    v = _randn(cuda, (B, Sk, KV, D), dtype)
    do = _randn(cuda, (B, Sq, H, D), dtype)
    code = 0 if dtype is torch.float32 else 1
    o, lse = fa._launch(q, k, v, causal, window, 0, D ** -0.5, code,
                        with_lse=True)
    n0 = fa.BACKWARD_LAUNCHES
    got = fa.attention_backward(q, k, v, o, lse, do, **kw)
    assert fa.BACKWARD_LAUNCHES == n0 + 1
    plain_lse = fa.attention_lse_plain(q, k, **kw)
    o32 = fa.attention_plain(q.float(), k.float(), v.float(), **kw)
    want = fa.attention_backward_plain(q.float(), k.float(), v.float(), o32,
                                       plain_lse, do.float(), **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert float((g.float() - w).abs().max()) <= _grad_tol(dtype, w)
    again = fa.attention_backward(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 12288), (64, 16384), (5, 16384)])
def test_rmsnorm_backward_kernel_past_12288_columns(cuda, dtype, rows, d):
    """command-r's 12,288 and llama3's 16,384 (3 warps a block there)."""
    x = _randn(cuda, (rows, d), dtype)
    scale = 1 + 0.1 * torch.randn((d,), generator=cuda, device="cuda")
    dy = _randn(cuda, (rows, d), dtype)
    n0 = rn.BACKWARD_LAUNCHES
    got = rn.rmsnorm_backward(x, scale, dy)
    assert rn.BACKWARD_LAUNCHES == n0 + 1
    want = rn.rmsnorm_backward_plain(x, scale, dy)
    for g, w in zip(got, want):
        assert float((g.float() - w.float()).abs().max()) <= _grad_tol(
            dtype, w)
    with pytest.raises(ValueError, match="no backward kernel"):
        rn.rmsnorm(_randn(cuda, (2, 65536), dtype).requires_grad_(),
                   torch.ones(65536, device="cuda"))


def test_train_step_on_card_matches_the_cpu(cuda):
    """One fp32 train step of a small paper_demo (head_dim 64, so the
    backward kernel takes it) on the card, through the kernels, against the
    same step on the CPU through the plain versions, from one state: the
    loss, AdamW's moments (the gradient) per leaf within 1e-4 of the leaf's
    max, and the params there too wherever the gradient is above 100 eps
    (AdamW's first update of a gradient near eps turns on its last bits,
    so two correct sums may differ there by up to 2 lr)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.optim import OptConfig
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = dataclasses.replace(
        get_config("paper_demo", reduced=True, dtype=torch.float32,
                   param_dtype=torch.float32), head_dim=64, n_heads=6,
        n_kv_heads=2)
    opt = OptConfig(lr=1e-3)
    cpu = init_train_state(cfg, opt, seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    step = make_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    b0, f0 = rn.BACKWARD_LAUNCHES, fa.BACKWARD_LAUNCHES
    cpu, mc = step(cpu, {"tokens": tokens})
    card, mg = step(card, {"tokens": tokens.cuda()})
    assert abs(float(mc["loss"]) - float(mg["loss"])) <= 1e-5
    assert rn.BACKWARD_LAUNCHES - b0 == 2 * cfg.n_layers + 1
    assert fa.BACKWARD_LAUNCHES - f0 == cfg.n_layers

    def rel(a, b, mask=None):
        d = (a.cpu() - b).abs()
        d = d[mask] if mask is not None else d
        return float(d.max()) / float(b.abs().max()) if d.numel() else 0.0
    for name in ("m", "v"):
        for a, b in zip(tree_leaves(card["opt"][name]),
                        tree_leaves(cpu["opt"][name])):
            assert rel(a, b) <= 1e-4
    for a, b, m in zip(tree_leaves(card["params"]), tree_leaves(cpu["params"]),
                       tree_leaves(cpu["opt"]["m"])):
        assert rel(a, b, m.abs() > (1 - opt.b1) * 1e-6) <= 1e-4

"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode) and pure-jnp references, on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds each against these plain versions there); here the wrappers take
the plain version because the tensors lie on the CPU, and refuse any
other non-CUDA device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as fa_kernel
from repro.kernels.flash_attention import ref as fa_ref
from repro.kernels.paged_attention import kernel as pa_kernel
from repro.kernels.paged_attention import ref as pa_ref
from repro.kernels.rmsnorm import kernel as rn_kernel
from repro.kernels.rmsnorm import ref as rn_ref
from repro.kernels.ssd_scan import kernel as ssd_kernel
from repro.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd

RMS_TOL = dict(atol=1e-6, rtol=1e-6)
TOL = dict(atol=2e-5, rtol=2e-5)      # the JAX kernel tests' float32 TOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small shapes gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("shape", [(8, 768), (3, 128), (4, 5, 256), (1, 64)])
def test_rmsnorm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    got = rn.rmsnorm(_t(x), _t(scale)).numpy()
    want_ref = np.asarray(rn_ref.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    want_kernel = np.asarray(rn_kernel.rmsnorm(
        jnp.asarray(x), jnp.asarray(scale), interpret=True))
    np.testing.assert_allclose(got, want_ref, **RMS_TOL)
    np.testing.assert_allclose(got, want_kernel, **RMS_TOL)


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,q_offset", [
    (1, 64, 64, 4, 4, 32, True, 0, 0),        # causal MHA
    (2, 64, 64, 4, 2, 32, False, 0, 0),       # non-causal GQA
    (1, 96, 96, 6, 2, 64, True, 0, 0),        # GQA, G=3 as paper_demo
    (1, 64, 64, 4, 2, 32, True, 17, 0),       # sliding window
    (2, 1, 40, 4, 2, 32, True, 0, 39),        # decode row at an offset
    (1, 64, 100, 2, 2, 32, False, 0, 0),      # KV tail needing padding
])
def test_flash_attention_matches_jax(B, Sq, Sk, H, KV, D, causal, window,
                                     q_offset):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = fa.attention(_t(q), _t(k), _t(v), **kw).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_ref = np.asarray(fa_ref.attention(jq, jk, jv, **kw))
    want_kernel = np.asarray(fa_kernel.flash_attention(
        jq, jk, jv, block_q=min(Sq, 32), block_k=32, interpret=True, **kw))
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)


@pytest.mark.parametrize("D", [120, 128])
@pytest.mark.parametrize("Sq,Sk,window,q_offset", [
    (64, 64, 0, 0),           # causal prefill
    (80, 80, 24, 0),          # sliding window (h2o-danube3 at hd 120)
    (16, 56, 20, 40),         # a windowed chunk at an offset
])
def test_flash_attention_matches_jax_at_ported_head_dims(D, Sq, Sk, window,
                                                         q_offset):
    """The plain version at the head dims of the ported dense configs (120:
    h2o-danube3; 128: deepseek-coder, llama3, command-r), GQA 8/2, against
    the JAX reference and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(2)
    H, KV = 8, 2
    q = rng.normal(size=(1, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(1, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(1, Sk, KV, D)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = fa.attention(_t(q), _t(k), _t(v), **kw).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_ref = np.asarray(fa_ref.attention(jq, jk, jv, **kw))
    want_kernel = np.asarray(fa_kernel.flash_attention(
        jq, jk, jv, block_q=16, block_k=8, interpret=True, **kw))
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_kernel, **TOL)


# ------------------------------------------------------------ paged attention
def _scenario(seed, S, W, H, KV, hd, ps, T, n_real, positions, n_valid,
              tables=None):
    """Random pool + per-slot tables (disjoint footprints, null-padded),
    as in the JAX package's paged-attention tests."""
    rng = np.random.default_rng(seed)
    if tables is None:
        tables = np.full((S, T), n_real, np.int32)
        nxt = 0
        for s in range(S):
            need = min(T, -(-(positions[s] + W) // ps))
            for e in range(need):
                tables[s, e] = nxt % n_real
                nxt += 1
    arrs = dict(
        q=rng.normal(size=(S, W, H, hd)),
        k_new=rng.normal(size=(S, W, KV, hd)),
        v_new=rng.normal(size=(S, W, KV, hd)),
        k_pages=rng.normal(size=(n_real + 1, ps, KV, hd)),
        v_pages=rng.normal(size=(n_real + 1, ps, KV, hd)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    ints = dict(tables=np.asarray(tables, np.int32),
                positions=np.asarray(positions, np.int32),
                n_valid=np.asarray(n_valid, np.int32))
    return arrs, ints, n_real


def _compare(arrs, ints, null):
    ps = arrs["k_pages"].shape[1]
    jargs = {k: jnp.asarray(v) for k, v in {**arrs, **ints}.items()}
    o_r, k_r, v_r = pa_ref.paged_attention(**jargs, page_size=ps)
    o_k, k_k, v_k = pa_kernel.paged_attention(**jargs, page_size=ps,
                                              interpret=True)
    targs = {k: _t(v) for k, v in {**arrs, **ints}.items()}
    o, k_p, v_p = pa.paged_attention(**targs, page_size=ps)
    # the pools are updated in place
    assert k_p.data_ptr() == targs["k_pages"].data_ptr()
    for o_j, k_j, v_j in ((o_r, k_r, v_r), (o_k, k_k, v_k)):
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
        # bit-exact on every REAL page; the null page is excluded by
        # contract (the JAX reference parks rejected rows there)
        np.testing.assert_array_equal(k_p.numpy()[:null],
                                      np.asarray(k_j)[:null])
        np.testing.assert_array_equal(v_p.numpy()[:null],
                                      np.asarray(v_j)[:null])
    # rows past n_valid are written nowhere, the null page included
    np.testing.assert_array_equal(k_p.numpy()[null], arrs["k_pages"][null])
    return o.numpy(), k_p.numpy()


@pytest.mark.parametrize("ps", [4, 8])
def test_paged_decode_matches_jax(ps):
    """W=1 decode, positions straddling page boundaries."""
    arrs, ints, null = _scenario(1, 4, 1, 4, 2, 16, ps, 4, 10,
                                 [0, ps - 1, ps, 2 * ps + 1], [1, 1, 1, 1])
    _compare(arrs, ints, null)


@pytest.mark.parametrize("K", [0, 2])
def test_paged_window_matches_jax(K):
    """1+K windows at ragged positions with an idle slot and a slot whose
    tail is rejected (n_valid < W)."""
    ps, W = 4, 4
    arrs, ints, null = _scenario(0, 4, W, 4, 2, 16, ps, 6, 12,
                                 [ps + 1, 3 * ps - 1, 0, 2 * ps],
                                 [1 + K, max(1, K), 0, 1 + K])
    _compare(arrs, ints, null)


def test_paged_suffix_window_matches_jax():
    """S=1 page-padded suffix prefill (n_valid = real tail < W)."""
    arrs, ints, null = _scenario(2, 1, 16, 4, 2, 16, 8, 6, 5, [8], [13])
    _compare(arrs, ints, null)


def test_paged_idle_slot_writes_nothing_outputs_zero():
    arrs, ints, null = _scenario(3, 2, 2, 4, 2, 16, 8, 3, 4, [5, 9], [0, 0])
    o, k_p = _compare(arrs, ints, null)
    assert np.all(o == 0)
    np.testing.assert_array_equal(k_p, arrs["k_pages"])


def test_paged_rows_past_n_valid_touch_no_page():
    """Rows j < n_valid land at position pos+j of the slot's footprint;
    rows past it leave every page (null page included) unchanged."""
    ps, W, nv, pos = 4, 4, 2, 3
    arrs, ints, null = _scenario(4, 1, W, 4, 2, 16, ps, 4, 6, [pos], [nv])
    _, k_p = _compare(arrs, ints, null)
    tables = ints["tables"]
    for j in range(W):
        page, row = tables[0, (pos + j) // ps], (pos + j) % ps
        want = arrs["k_new"][0, j] if j < nv else arrs["k_pages"][page, row]
        np.testing.assert_array_equal(k_p[page, row], want)


def test_paged_shared_page_read_only():
    """Two slots reading one shared prefix page leave it bit-exact."""
    ps, W = 4, 2
    tables = np.array([[0, 1, 3, 3], [0, 2, 3, 3]], np.int32)
    arrs, ints, null = _scenario(5, 2, W, 4, 2, 16, ps, 4, 3, [ps + 1, ps],
                                 [2, 2], tables=tables)
    _, k_p = _compare(arrs, ints, null)
    np.testing.assert_array_equal(k_p[0], arrs["k_pages"][0])


@pytest.mark.parametrize("G", [8, 16])
@pytest.mark.parametrize("W,positions,n_valid", [
    (1, [5, 17, 30, 0], [1, 1, 1, 0]),      # decode, one idle slot
    (4, [8, 13], [4, 3]),                   # suffix windows
])
def test_paged_matches_jax_at_head_dim_128(G, W, positions, n_valid):
    """The plain paged version at head_dim 128 with deepseek's 8 and
    llama3's 16 q-heads per KV head, against the JAX reference and the
    Pallas kernel in interpret mode."""
    S, KV, ps, T = len(positions), 2, 8, 5
    n_real = sum(min(T, -(-(p + W) // ps)) for p in positions)
    arrs, ints, null = _scenario(7, S, W, KV * G, KV, 128, ps, T, n_real,
                                 positions, n_valid)
    o, _ = _compare(arrs, ints, null)
    for s, n in enumerate(n_valid):
        if n == 0:
            assert np.all(o[s] == 0)


@pytest.mark.parametrize("S,W,ps,T,positions,n_valid,split_len", [
    pytest.param(2, 1, 4, 8, [3, 9], [1, 1], 8, id="split-no-visible-key"),
    pytest.param(3, 2, 4, 6, [5, 0, 12], [2, 0, 1], 8, id="idle-slot"),
    pytest.param(1, 6, 4, 6, [13], [6], 8, id="window-straddles-split"),
    pytest.param(2, 5, 4, 8, [6, 17], [3, 2], 8, id="n-valid-below-W"),
    pytest.param(2, 1, 4, 4, [15, 7], [1, 1], 8, id="position-T-ps-minus-1"),
    pytest.param(2, 3, 4, 5, [14, 4], [3, 3], 8, id="split-not-dividing"),
    pytest.param(4, 1, 16, 8, [0, 63, 64, 127], [1, 1, 1, 1], 64,
                 id="kernel-split-decode"),
    pytest.param(2, 3, 4, 3, [2, 5], [3, 2], 1, id="one-position-splits"),
])
def test_paged_split_merge_matches_plain_and_jax(S, W, ps, T, positions,
                                                 n_valid, split_len):
    """The CUDA kernel's partition (per-split (m, l, acc) over position
    ranges, merged by rescaling) against the plain version and the JAX
    reference, fp32 at 1e-5."""
    n_real = sum(min(T, -(-(p + W) // ps)) for p in positions)
    arrs, ints, _ = _scenario(6, S, W, 4, 2, 16, ps, T, n_real, positions,
                              n_valid)
    both = {**arrs, **ints}
    got = pa._paged_split_merge_plain(
        **{k: _t(v) for k, v in both.items()}, page_size=ps,
        split_len=split_len).numpy()
    want, _, _ = pa.paged_attention_plain(
        **{k: _t(v) for k, v in both.items()}, page_size=ps)
    want_jax, _, _ = pa_ref.paged_attention(
        **{k: jnp.asarray(v) for k, v in both.items()}, page_size=ps)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want.numpy(), **tol)
    np.testing.assert_allclose(got, np.asarray(want_jax), **tol)
    for s, n in enumerate(n_valid):
        if n == 0:
            assert np.all(got[s] == 0)


# ------------------------------------------------------------------ SSD scan
@pytest.mark.parametrize("B,T,H,P,G,N,bf16", [
    (2, 64, 4, 16, 1, 16, False),     # two full chunks
    (1, 37, 4, 16, 2, 16, False),     # prime T (masked tail chunk), G > 1
    (2, 20, 4, 8, 4, 8, False),       # T < chunk, one group per head
    (1, 96, 2, 16, 1, 16, False),     # three chunks
    (1, 50, 4, 16, 2, 16, True),      # bf16, masked tail
])
def test_ssd_scan_matches_jax(B, T, H, P, G, N, bf16):
    """The port keeps chunk 32 and pads the tail; the reference runs the
    largest chunk that divides T (1 for a prime T above 32), as the JAX
    model's chunk search picks it. y and the final state agree to fp32
    rounding (1e-4), or in bf16 to one rounding step of |y| < 2 (2e-2)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, H, P))
    dt = np.log1p(np.exp(rng.normal(size=(B, T, H)))) * 0.1
    A = -np.exp(rng.normal(size=H)) * 0.5
    Bm = rng.normal(size=(B, T, G, N)) * N ** -0.25
    Cm = rng.normal(size=(B, T, G, N)) * N ** -0.25
    D = rng.normal(size=H) * 0.1
    f32 = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else \
        (torch.float32, jnp.float32)
    targs = [_t(a) for a in f32]
    jargs = [jnp.asarray(a) for a in f32]
    for i in (0, 3, 4):              # x, B and C in the working dtype
        targs[i] = targs[i].to(tdt)
        jargs[i] = jargs[i].astype(jdt)
    chunk = min(32, T)
    while T % chunk:
        chunk -= 1
    y, final = ssd.ssd_scan(*targs, chunk=32, return_state=True)
    assert y.dtype == tdt and final.dtype == torch.float32
    assert torch.equal(ssd.ssd_scan(*targs, chunk=32), y)
    want_y, want_state = ssd_ref.ssd_chunked(*jargs, chunk=chunk)
    want_kernel = ssd_kernel.ssd_scan(*jargs, chunk=chunk, interpret=True)
    tol = dict(atol=2e-2 if bf16 else 1e-4, rtol=0)
    got = y.float().numpy()
    assert not bf16 or np.abs(got).max() < 2
    np.testing.assert_allclose(got, np.asarray(want_y, np.float32), **tol)
    np.testing.assert_allclose(got, np.asarray(want_kernel, np.float32),
                               **tol)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_state), **tol)


def _mamba2_ssd_inputs(T, H=32, P=64, N=128):
    """mamba2-370m's SSD widths at B = 1, inputs drawn as on the card
    (``chip_smoke.ssd_inputs``): dt ~ softplus(N(-3, 0.5)), A =
    -linspace(1, 16), B and C ~ N(0, 1) / N^(1/4), D ~ 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(T)
    x = 0.5 * rng.normal(size=(1, T, H, P))
    dt = np.log1p(np.exp(0.5 * rng.normal(size=(1, T, H)) - 3))
    A = -np.linspace(1.0, 16.0, H)
    Bm = rng.normal(size=(1, T, 1, N)) * N ** -0.25
    Cm = rng.normal(size=(1, T, 1, N)) * N ** -0.25
    D = 1 + 0.1 * rng.normal(size=H)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("T", [64, 509, 512])
def test_ssd_chunk_parallel_matches_plain_and_jax(T, bf16):
    """The CUDA kernel's decomposition (chunk states, state passing, chunk
    scan) with the operand rounding of its bf16 tensor-core products
    (fp32: none, as the fp32 kernel's FMAs) against the plain version, the
    JAX reference and the Pallas kernel (interpret mode): y within 2e-2
    (bf16) or 1e-4 (fp32), the final state within 1e-4 in both. In bf16,
    rounding diag(w) x to bf16 once, as the other operands are, would put
    the state past 1e-4: that is why the kernel splits it into hi + lo."""
    f32 = _mamba2_ssd_inputs(T)
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else \
        (torch.float32, jnp.float32)
    targs = [_t(a) for a in f32]
    jargs = [jnp.asarray(a) for a in f32]
    for i in (0, 3, 4):              # x, B and C in the working dtype
        targs[i] = targs[i].to(tdt)
        jargs[i] = jargs[i].astype(jdt)
    rounding = ssd.KERNEL_ROUNDING if bf16 else None
    y, state = ssd._ssd_chunk_parallel_plain(*targs, return_state=True,
                                             rounding=rounding)
    y_plain, state_plain = ssd.ssd_scan_plain(*targs, return_state=True)
    # the JAX side needs a chunk that divides T; one chunk of a prime T
    # is the same function (the quadratic form over the whole sequence)
    chunk = ssd.CHUNK if T % ssd.CHUNK == 0 else T
    want_y, want_state = ssd_ref.ssd_chunked(*jargs, chunk=chunk)
    want_kernel = ssd_kernel.ssd_scan(*jargs, chunk=chunk, interpret=True)
    y_tol = 2e-2 if bf16 else 1e-4
    got = y.float().numpy()
    assert np.abs(got).max() < 4     # within one bf16 step of 2e-2
    for want in (y_plain.float().numpy(), np.asarray(want_y, np.float32),
                 np.asarray(want_kernel, np.float32)):
        np.testing.assert_allclose(got, want, atol=y_tol, rtol=0)
    for want in (state_plain.numpy(), np.asarray(want_state)):
        np.testing.assert_allclose(state.numpy(), want, atol=1e-4, rtol=0)
    if bf16:
        _, state_once = ssd._ssd_chunk_parallel_plain(
            *targs, return_state=True,
            rounding={k: "once" for k in ssd.KERNEL_ROUNDING})
        assert float((state_once - state_plain).abs().max()) > 1e-4


# ------------------------------------------------------------- no fallback
def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain versions; any other device must
    launch a kernel or raise (here: the meta device, which has none)."""
    meta = dict(device="meta")
    x = torch.empty((8, 64), **meta)
    with pytest.raises(ValueError, match="no kernel"):
        rn.rmsnorm(x, torch.empty((64,), **meta))
    q = torch.empty((1, 4, 2, 32), **meta)
    with pytest.raises(ValueError, match="no kernel"):
        fa.attention(q, q, q)
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_attention(q, q, q, torch.empty((3, 4, 2, 32), **meta),
                           torch.empty((3, 4, 2, 32), **meta),
                           torch.empty((1, 2), **i32),
                           torch.empty((1,), **i32),
                           torch.empty((1,), **i32), page_size=4)
    f32 = dict(dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ssd.ssd_scan(torch.empty((1, 64, 32, 64), **meta),
                     torch.empty((1, 64, 32), **f32),
                     torch.empty((32,), **f32),
                     torch.empty((1, 64, 1, 128), **meta),
                     torch.empty((1, 64, 1, 128), **meta),
                     torch.empty((32,), **f32))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No CUDA compiler means the kernel library cannot load: the error
    surfaces, nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOME_DEFAULT", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib()
    assert not (tmp_path / "build").exists()


def test_build_digest_tracks_sources():
    """The build directory is keyed by every kernel source."""
    names = {p.name for p in _build.sources()}
    assert names == {"rmsnorm.cu", "flash_attention.cu",
                     "paged_attention.cu", "ssd_scan.cu"}
    assert len(_build.digest()) == 16

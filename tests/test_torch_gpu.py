"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Elsewhere every test skips (the kernels have no CPU mode); the CPU tests
hold the plain versions against the JAX package instead.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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
@pytest.mark.parametrize("rows,d", [(8, 768), (513, 768), (3, 64)])
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
])
def test_flash_attention_kernel(cuda, dtype, Sq, Sk, H, KV, D, causal,
                                window, q_offset):
    q = _randn(cuda, (2, Sq, H, D), dtype)
    k = _randn(cuda, (2, Sk, KV, D), dtype)
    v = _randn(cuda, (2, Sk, KV, D), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    err = (fa.attention(q, k, v, **kw).float()
           - fa.attention_plain(q, k, v, **kw).float()).abs().max()
    assert float(err) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,positions,n_valid", [
    (1, [17, 100, 255, 0], [1, 1, 1, 0]),
    (16, [256], [13]),
    (40, [32], [40]),
])
def test_paged_attention_kernel(cuda, dtype, W, positions, n_valid):
    S, KV, G, hd, ps, T, P = len(positions), 4, 3, 64, 16, 24, 96
    tables = torch.full((S, T), P, dtype=torch.int32)
    perm = torch.randperm(P)
    nxt = 0
    for s in range(S):
        need = -(-(positions[s] + W) // ps)
        tables[s, :need] = perm[nxt:nxt + need]
        nxt += need
    args = [_randn(cuda, (S, W, KV * G, hd), dtype),
            _randn(cuda, (S, W, KV, hd), dtype),
            _randn(cuda, (S, W, KV, hd), dtype)]
    kp = _randn(cuda, (P + 1, ps, KV, hd), dtype)
    vp = _randn(cuda, (P + 1, ps, KV, hd), dtype)
    ints = [tables.cuda(), torch.tensor(positions, dtype=torch.int32).cuda(),
            torch.tensor(n_valid, dtype=torch.int32).cuda()]
    kk, vk, kq, vq = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    o, _, _ = pa.paged_attention(*args, kk, vk, *ints, page_size=ps)
    ref, _, _ = pa.paged_attention_plain(*args, kq, vq, *ints, page_size=ps)
    assert float((o.float() - ref.float()).abs().max()) <= TOL[dtype]
    # pools bit-exact everywhere: neither version writes the null page
    assert torch.equal(kk, kq) and torch.equal(vk, vq)
    assert torch.equal(kk[P], kp[P])

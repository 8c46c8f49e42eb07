"""Attention (causal / sliding-window / non-causal, GQA): plain PyTorch
version + CUDA kernel wrapper, and its gradient.

Counterpart of ``repro/kernels/flash_attention/{kernel,ref,ops}.py``; the
kernels are ``csrc/flash_attention.cu``: the forward, which also writes
each row's log-sum-exp when the backward will need it, and a backward
kernel (no TPU counterpart), both at every head_dim of ``HEAD_DIMS``.

The wrapper's rule: CPU tensors take the plain version, which autograd
differentiates natively. A CUDA call with grad enabled and an input that
requires grad goes through ``_FlashFunction`` (the forward kernel writing
the log-sum-exp, then the backward kernel). Any other CUDA call is the
forward launch alone, writing no log-sum-exp, as serving makes it. The
backward kernel splits a KV group's query heads over several dK/dV blocks
when the grid would not fill the card (``backward_splits``); the wrapper
then allocates the fp32 scratch of their partial sums.
DTensors run each rank's shard through this same rule
(``kernels._shards``): batch and heads may be sharded, with each rank's q
heads beside their own KV heads; the sequence and head_dim may not. Meta
shards (the dry run's) take the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _shards

#: kernel launches in this process (the wrapper's CUDA path only)
LAUNCHES = 0
#: backward kernel calls (three grids each: delta, dK/dV, dQ; a fourth
#: that sums the dK/dV partials when the group's heads are split)
BACKWARD_LAUNCHES = 0
HEAD_DIMS = (64, 120, 128)   # the kernels' instantiations (ported configs)
BACKWARD_HEAD_DIMS = HEAD_DIMS   # the backward kernel's: the same
#: the card's SMs: the dK/dV grid is split until it fills two waves
SMS = 132


def _mask(Sq: int, Sk: int, causal: bool, window: int, q_offset: int,
          device) -> torch.Tensor:
    """(Sq, Sk) bool: key ``j`` visible to query ``i``."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Mirror of the JAX ``ref.attention`` (non-lean path).

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H % KV == 0. ``q_offset``
    is the absolute position of q[0] minus that of k[0]; ``window`` > 0
    keeps each query's last ``window`` keys. Softmax in fp32 with the
    ``-1e30`` mask.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    groups = H // KV
    scale = D ** -0.5 if scale is None else scale
    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Each query row's log-sum-exp of its visible scaled scores, fp32
    ``(B, H, Sq)``, as the forward kernel writes it: ``+inf`` for a row
    that sees no key."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    k = k.repeat_interleave(H // KV, dim=2)
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(scores.masked_fill(~mask, -float("inf")), dim=-1)
    return lse.masked_fill(~mask.any(dim=-1), float("inf"))


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             q_offset: int = 0,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` of attention at ``q, k, v`` with output ``o``,
    row log-sum-exp ``lse (B, H, Sq)`` and output gradient ``do``, in fp32,
    cast to ``q.dtype`` (the backward kernel's plain version):
    ``P = exp(scale q k^T - lse)`` (0 where masked), ``dv = P^T do``,
    ``dS = P (do v^T - rowsum(do o))``, ``dq = scale dS k``, ``dk = scale
    dS^T q``; a KV head's dk and dv sum its group's query heads."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5 if scale is None else scale
    qf, of, gf = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    mask = _mask(Sq, Sk, causal, window, q_offset, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    delta = (gf * of).sum(dim=-1).transpose(1, 2)              # (B, H, Sq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dk = dk.reshape(B, Sk, KV, G, D).sum(dim=3)
    dv = dv.reshape(B, Sk, KV, G, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def backward_key_tile(dtype: torch.dtype, D: int) -> int:
    """Keys a block of the backward's dK/dV grid holds: 128 for fp32 at
    head_dim 64 (8 x 8 register micro-tiles), else 64."""
    return 128 if dtype == torch.float32 and D == 64 else 64


def backward_splits(B: int, Sk: int, H: int, KV: int,
                    key_tile: int = 64) -> int:
    """Blocks a KV group's query heads are split over in the backward's
    dK/dV grid: the smallest divisor of the group size ``H // KV`` that
    gives at least two waves of ``SMS`` blocks of (``key_tile`` keys, KV
    head, batch) (1 when the grid already does, the whole group when none
    does). Each block sums its share of the heads; the shares are added
    in split order (``attention_backward``)."""
    G = H // KV
    blocks = B * KV * -(-Sk // key_tile)
    for s in range(1, G + 1):
        if G % s == 0 and blocks * s >= 2 * SMS:
            return s
    return G


def _attention_backward_split_plain(q, k, v, o, lse, do, splits: int, *,
                                    causal: bool = True, window: int = 0,
                                    q_offset: int = 0,
                                    scale: Optional[float] = None):
    """The backward kernel's split dK/dV grid in plain fp32 PyTorch, for
    the tests: each KV group's query heads cut into ``splits`` shares of
    consecutive heads, each share's unscaled dK and its dV summed over its
    heads, the shares added in split order, then dK scaled. dq is
    ``attention_backward_plain``'s. Returns fp32 ``(dq, dk, dv)``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if G % splits:
        raise ValueError(f"{splits} splits do not divide a group of {G}")
    scale = D ** -0.5 if scale is None else scale
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    dq, _, _ = attention_backward_plain(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), **kw)
    n = G // splits
    dk = dv = 0.0
    for s in range(splits):
        heads = [kv * G + g for kv in range(KV)
                 for g in range(s * n, (s + 1) * n)]
        _, pk, pv = attention_backward_plain(
            q.float()[:, :, heads], k.float(), v.float(),
            o.float()[:, :, heads], lse[:, heads], do.float()[:, :, heads],
            **kw)
        dk = dk + pk / scale
        dv = dv + pv
    return dq, dk * scale, dv


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Validate a CUDA call; returns the dtype code."""
    _build.require_cuda("flash_attention", q, k, v)
    code = _build.dtype_code("flash_attention", q.dtype)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KV, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if H % KV or D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: needs H % KV == 0 and D in "
                         f"{HEAD_DIMS}, got H={H} KV={KV} D={D}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q/k/v must be 16-byte aligned")
    return code


def _launch(q, k, v, causal, window, q_offset, scale, code,
            with_lse: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel; with ``with_lse`` it also writes the row
    log-sum-exp ``(B, H, Sq)`` fp32, else it writes none."""
    global LAUNCHES
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    rc = _build.lib().repro_flash_attention(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, Sq, Sk, H, KV, D, int(causal), int(window), int(q_offset),
        float(scale), _build.stream_handle(q))
    _build.check(rc, "flash_attention")
    LAUNCHES += 1
    return out, lse


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       *, causal: bool = True, window: int = 0,
                       q_offset: int = 0, scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel: ``(dq, dk, dv)`` for CUDA tensors, from the
    forward's output ``o`` and log-sum-exp ``lse``."""
    global BACKWARD_LAUNCHES
    code = _check(q, k, v)
    _build.require_cuda("flash_attention_backward", q, o, lse, do)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("flash_attention_backward: o and do must have q's "
                         "shape and dtype")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"flash_attention_backward: lse must be fp32 "
                         f"{(B, H, Sq)}, got {lse.dtype} {tuple(lse.shape)}")
    scale = D ** -0.5 if scale is None else scale
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    splits = backward_splits(B, Sk, H, KV, backward_key_tile(q.dtype, D))
    # the split dK/dV grid's fp32 partial sums (dk's, then dv's)
    part = torch.empty((2, splits, B, Sk, KV, D), dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    rc = _build.lib().repro_flash_attention_backward(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        part.data_ptr() if part is not None else None, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, KV, D, splits,
        int(causal), int(window), int(q_offset), float(scale),
        _build.stream_handle(q))
    _build.check(rc, "flash_attention_backward")
    BACKWARD_LAUNCHES += 1
    return dq, dk, dv


class _FlashFunction(torch.autograd.Function):
    """The forward kernel (writing the log-sum-exp), differentiated by the
    backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, code):
        out, lse = _launch(q, k, v, causal, window, q_offset, scale, code,
                           with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, scale = ctx.args
        dq, dk, dv = attention_backward(
            q, k, v, out, lse, do.contiguous(), causal=causal, window=window,
            q_offset=q_offset, scale=scale)
        return dq, dk, dv, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel,
    through the autograd function when a gradient is wanted (see the
    module's docstring). Returns (B, Sq, H, D) in q's dtype."""
    if _shards.any_dtensor(q, k, v):
        return _attention_shards(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, scale=scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
    code = _check(q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFunction.apply(q, k, v, causal, window, q_offset, scale,
                                    code)
    return _launch(q, k, v, causal, window, q_offset, scale, code,
                   with_lse=False)[0]


def _attention_shards(q, k, v, **kw):
    """``attention`` of DTensors on each rank's shard: q, k and v sharded
    alike on batch (dim 0) and heads (dim 2), q's heads and k's split
    evenly, so that rank ``r`` holds q heads ``[r·H/m, (r+1)·H/m)`` and
    exactly their KV heads."""
    name = "flash_attention"
    if not _shards.any_dtensor(q):
        raise ValueError(f"{name}: DTensor K/V need a DTensor q")
    _shards.check(name, "q", q, (0, 2))
    for what, t in (("k", k), ("v", v)):
        _shards.same(name, what, q, t, {0: 0, 2: 2})
    _shards.divides(name, q, 2, (q.shape[2], k.shape[2]))
    split = _shards.split_dims(q, k, v)
    fn = attention_plain if _shards.on_meta(q) else attention
    out = fn(*(_shards.local(t, split) for t in (q, k, v)), **kw)
    return _shards.wrap(out, q, q.shape)

"""Forward attention (causal / sliding-window / non-causal, GQA): plain
PyTorch version + CUDA kernel wrapper.

Counterpart of ``repro/kernels/flash_attention/{kernel,ref,ops}.py``; the
kernel is ``csrc/flash_attention.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

#: kernel launches in this process (the wrapper's CUDA path only)
LAUNCHES = 0
HEAD_DIMS = (64, 120, 128)   # the kernels' instantiations (ported configs)


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
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel.
    Returns (B, Sq, H, D) in q's dtype."""
    global LAUNCHES
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
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
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    rc = _build.lib().repro_flash_attention(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, D, int(causal), int(window), int(q_offset),
        float(scale), _build.stream_handle(q))
    _build.check(rc, "flash_attention")
    LAUNCHES += 1
    return out

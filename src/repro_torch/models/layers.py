"""Shared layers: norms, rotary embeddings, gated MLP, embeddings.

Counterpart of ``repro/models/layers.py``: plain functions on tensors with
the reference's parameter layouts (``wi``/``wg`` ``(d, ff)``, ``wo``
``(ff, d)``, embedding ``(V, d)``). The reference's ``gathered`` /
``constrain`` are sharding annotations; on one device they are no-ops and
are dropped.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as rms_kernel
from repro_torch.models.common import ModelConfig


# ---------------------------------------------------------------------- init
#: elements drawn at once by ``init_normal`` (1 GiB of fp32)
_INIT_CHUNK = 1 << 28


def init_normal(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """``normal * scale`` of ``shape`` in ``dtype``, drawn from ``gen`` in
    fp32 a chunk at a time: a stack of expert weights in bf16 (13 GB for
    8 layers of qwen3-moe's ``wi``) never has its fp32 draw whole on the
    card."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), _INIT_CHUNK):
        n = min(_INIT_CHUNK, flat.numel() - s)
        flat[s:s + n] = torch.randn(n, generator=gen, device=device) * scale
    return out


# --------------------------------------------------------------------- norm
def rmsnorm(params: Dict[str, Any], x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    return rms_kernel.rmsnorm(x, params["scale"], eps=eps)


# --------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float,
                     device: Any = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)          # (head_dim/2,)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(cos, sin)`` of shape ``(..., S, 1, head_dim/2)`` for
    ``positions (..., S)``: computed once per forward and shared by every
    layer's q and k."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      lean: bool = False) -> torch.Tensor:
    """Rotate ``x (..., S, heads, head_dim)`` by precomputed tables.
    ``lean`` applies the rotators in x's own dtype (the reference's §Perf
    variant); otherwise the rotation runs in fp32."""
    if lean:
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               lean: bool = False) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return apply_rope_tables(x, cos, sin, lean=lean)


# ---------------------------------------------------------------------- mlp
def mlp(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP."""
    h = x @ params["wi"].to(x.dtype)
    g = x @ params["wg"].to(x.dtype)
    return (F.silu(g) * h) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------- embedding
def embed_tokens(params: Dict[str, Any], tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens, params["tokens"]).to(cfg.dtype)


def lm_logits(params: Dict[str, Any], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Logits over the (padded) vocabulary; the padded tail is masked to
    ``-1e30``."""
    if cfg.tied_embeddings:
        logits = x @ params["tokens"].to(cfg.dtype).t()
    else:
        logits = x @ params["head"].to(cfg.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits

"""GQA attention for the dense decoder: prefill, dense decode and fused
paged decode, with RoPE and head padding.

Counterpart of ``repro/models/attention.py`` (``head_mask``,
``init_kv_cache``, ``_project_qkv``, ``prefill_attention``,
``decode_attention``, ``paged_decode_attention``, and the enc-dec's
``precompute_cross_kv`` and ``cross_attention``). Weights keep the
reference's layouts: ``wq`` ``(d, H, hd)``, ``wk``/``wv`` ``(d, KV, hd)``,
``wo`` ``(H, hd, d)``. Prefill attention is the flash kernel; paged decode
the paged kernel; dense decode is grouped PyTorch matmuls, as the
reference computes it with einsums outside any Pallas kernel.
Cross-attention runs the flash kernel non-causally against the encoder's
keys, at every query length (``Sq = 1`` at each decode step).

The sliding-window cache is a ring of ``L`` slots: absolute position ``p``
lives in slot ``p % L``, after prefill as after decode. The reference's
prefill keeps the last ``L`` prompt keys at slots ``0..L-1``, which its
decode reads as ring slots only when ``S % L == 0`` (ROADMAP C.6); the
port rolls them into place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import paged_attention as paged_kernel
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_rope_tables, init_normal,
                                       rope_tables)
from repro_torch.util import resolve_device

Rope = Tuple[torch.Tensor, torch.Tensor]


def head_mask(cfg: ModelConfig) -> np.ndarray:
    """Boolean (padded_heads,) mask of REAL q-head slots (padded slots sit
    at the tail of each kv group)."""
    Gp = cfg.padded_kv_groups
    n = np.arange(cfg.padded_heads)
    return (n // Gp < cfg.n_kv_heads) & (n % Gp < cfg.kv_groups)


def init_attention(cfg: ModelConfig, gen: torch.Generator, dev,
                   width: int = 0, lead: Tuple[int, ...] = ()
                   ) -> Dict[str, torch.Tensor]:
    """q/k/v/o weights at ``width`` (default ``d_model``; the reference's
    ``init_attention``), stacked on ``lead``; padded head slots carry zero
    q/o (and k/v) weights, so the function is exactly the unpadded
    architecture."""
    width = width or cfg.d_model
    Hp, KVp, hd = cfg.padded_heads, cfg.padded_kv_heads, \
        cfg.resolved_head_dim
    pd = cfg.param_dtype
    wq = init_normal(gen, lead + (width, Hp, hd), width ** -0.5, pd, dev)
    wk = init_normal(gen, lead + (width, KVp, hd), width ** -0.5, pd, dev)
    wv = init_normal(gen, lead + (width, KVp, hd), width ** -0.5, pd, dev)
    wo = init_normal(gen, lead + (Hp, hd, width), (Hp * hd) ** -0.5, pd, dev)
    if Hp != cfg.n_heads or KVp != cfg.n_kv_heads:
        mask = torch.as_tensor(head_mask(cfg), device=dev).to(pd)
        wq = wq * mask[:, None]
        wo = wo * mask[:, None, None]
    if KVp != cfg.n_kv_heads:
        wk[..., cfg.n_kv_heads:, :] = 0
        wv[..., cfg.n_kv_heads:, :] = 0
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: Optional[int] = None,
                  device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """Zeroed KV cache ``(n_layers?, batch, max_len, KV, hd)``; SWA
    configurations bound it at the window size."""
    device = resolve_device(device)
    if cfg.window:
        max_len = min(max_len, cfg.window)
    shape = (batch, max_len, cfg.padded_kv_heads, cfg.resolved_head_dim)
    if n_layers:
        shape = (n_layers,) + shape
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _rope(cfg: ModelConfig, positions: torch.Tensor) -> Optional[Rope]:
    """Rotary tables of ``positions``; None without RoPE (``rope_theta``
    0: whisper's sinusoidal positions), which ``_project_qkv`` never
    reads then."""
    if cfg.rope_theta <= 0:
        return None
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                 rope: Optional[Rope]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, H, hd), k/v (B, S, KV, hd); ``rope`` = ``rope_tables`` of
    the rows' absolute positions."""
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"].to(cfg.dtype).reshape(d, -1)).view(B, S, -1, hd)
    k = (x @ params["wk"].to(cfg.dtype).reshape(d, -1)).view(B, S, -1, hd)
    v = (x @ params["wv"].to(cfg.dtype).reshape(d, -1)).view(B, S, -1, hd)
    if cfg.rope_theta > 0:
        cos, sin = rope
        q = apply_rope_tables(q, cos, sin, lean=cfg.lean_attention)
        k = apply_rope_tables(k, cos, sin, lean=cfg.lean_attention)
    return q, k, v


def _out_proj(params, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S = o.shape[:2]
    wo = params["wo"].to(cfg.dtype)
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def attention_block(params, x: torch.Tensor, cfg: ModelConfig, *,
                    rope: Optional[Rope] = None,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (forward without cache)."""
    if rope is None:
        rope = _rope(cfg, torch.arange(x.shape[1], device=x.device)[None])
    q, k, v = _project_qkv(params, x, cfg, rope)
    o = flash_kernel.attention(q, k, v, causal=causal, window=cfg.window)
    return _out_proj(params, o, cfg)


def prefill_attention(params, x: torch.Tensor, cfg: ModelConfig,
                      cache: Dict[str, torch.Tensor],
                      rope: Optional[Rope] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: causal attention (flash kernel) + fill the cache. ``cache``
    (B, L, KV, hd) is written in place; a sequence longer than L keeps its
    last L positions, position ``p`` in ring slot ``p % L``."""
    S = x.shape[1]
    if rope is None:
        rope = _rope(cfg, torch.arange(S, device=x.device)[None])
    q, k, v = _project_qkv(params, x, cfg, rope)
    o = flash_kernel.attention(q, k, v, causal=True, window=cfg.window)
    out = _out_proj(params, o, cfg)
    L = cache["k"].shape[1]
    if S >= L:
        # positions S-L .. S-1 into ring slots (S-L+i) % L: a roll by S % L
        cache["k"].copy_(torch.roll(k[:, S - L:], S % L, dims=1))
        cache["v"].copy_(torch.roll(v[:, S - L:], S % L, dims=1))
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    return out, cache


def row_positions(pos: Any, batch: int,
                  device: torch.device) -> torch.Tensor:
    """``pos`` as a ``(batch,)`` int64 tensor on ``device``: a host int is
    broadcast, a tensor of one position per row is taken as it is (never
    read back on the host)."""
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=device, dtype=torch.int64)
        return pos.expand(batch) if pos.dim() == 0 else pos.reshape(batch)
    return torch.full((batch,), int(pos), dtype=torch.int64, device=device)


def check_decode_span(cfg: ModelConfig, L: int, pos: Any, S1: int) -> None:
    """Only a ring of the whole window may wrap: a host position ``pos``
    whose ``S1`` tokens pass any other cache of ``L`` slots raises. A
    device tensor is never read back (the engine admits no request past
    such a cache)."""
    if isinstance(pos, torch.Tensor) or (cfg.window and L >= cfg.window):
        return
    if int(pos) + S1 > L:
        raise ValueError(f"decode at positions {int(pos)}..{int(pos) + S1 - 1}"
                         f" past a cache of {L}"
                         + (f" (window {cfg.window})" if cfg.window else ""))


def decode_attention(params, x: torch.Tensor, cfg: ModelConfig,
                     cache: Dict[str, torch.Tensor], pos: Any,
                     rope: Optional[Rope] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode ``S1`` new tokens per row, row ``b`` at absolute positions
    ``pos[b] .. pos[b]+S1-1`` (``pos`` an int or a ``(B,)`` tensor), against
    a dense cache (B, L, KV, hd), written in place. Grouped-einsum GQA (the
    cache is never repeated to the q-head count), fp32 softmax with the
    ``-1e30`` mask.

    With a sliding window the cache is a ring (reference
    ``decode_attention``, one token per row): the new key goes to slot
    ``pos % L``, and slot ``i`` holds the latest position ``<= pos``
    congruent to ``i``, visible when it is ``> pos - window``."""
    B, S1, _ = x.shape
    if cfg.window and S1 > 1:
        raise NotImplementedError(
            "multi-token decode against a SWA ring buffer")
    dev = x.device
    L = cache["k"].shape[1]
    check_decode_span(cfg, L, pos, S1)
    qpos = row_positions(pos, B, dev)[:, None] \
        + torch.arange(S1, device=dev)[None, :]                # (B, S1)
    if rope is None:
        rope = _rope(cfg, qpos)
    q, k, v = _project_qkv(params, x, cfg, rope)
    rows = torch.arange(B, device=dev)[:, None].expand(B, S1)
    # the remainder wraps the ring and keeps any other write in bounds
    slots = qpos % L
    cache["k"][rows, slots] = k
    cache["v"][rows, slots] = v
    ck, cv = cache["k"], cache["v"]
    KVp = cfg.padded_kv_heads
    G = cfg.padded_heads // KVp
    qg = q.reshape(B, S1, KVp, G, -1)
    idx = torch.arange(L, device=dev)
    if cfg.window:
        p = qpos[:, :1]                                         # (B, 1)
        held = idx[None, :] + torch.div(p - idx[None, :], L,
                                        rounding_mode="floor") * L
        valid = ((held >= 0) & (held <= p)
                 & (held > p - cfg.window))[:, None, :]         # (B, 1, L)
    else:
        valid = idx[None, None, :] <= qpos[:, :, None]          # (B, S1, L)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, ck).float() \
        * cfg.resolved_head_dim ** -0.5
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", probs, cv)
    o = o.reshape(B, S1, cfg.padded_heads, -1)
    return _out_proj(params, o, cfg), cache


def paged_decode_attention(params, x: torch.Tensor, cfg: ModelConfig,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           positions: torch.Tensor, tables: torch.Tensor,
                           n_valid: torch.Tensor, *, page_size: int,
                           rope: Optional[Rope] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Fused paged attention over one layer's page pool.

    ``x`` (S, W, d_model): S serve slots, each a W-row query window at
    absolute positions ``positions[s] + j``. ``tables (S, T)``, ``n_valid
    (S,)`` as in ``kernels.paged_attention``. Returns ``(out (S, W, d),
    k_pages, v_pages)``; the pools are updated in place.
    """
    S, W, _ = x.shape
    if rope is None:
        offs = torch.arange(W, device=x.device, dtype=positions.dtype)
        rope = _rope(cfg, positions[:, None] + offs[None, :])
    q, k, v = _project_qkv(params, x, cfg, rope)
    o, k_pages, v_pages = paged_kernel.paged_attention(
        q, k, v, k_pages, v_pages, tables, positions, n_valid,
        page_size=page_size, scale=cfg.resolved_head_dim ** -0.5)
    return _out_proj(params, o.to(cfg.dtype), cfg), k_pages, v_pages


# ------------------------------------------------------------ cross-attn
def precompute_cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """The encoder output's keys and values for one decoder layer:
    contiguous ``(B, T_enc, KVp, hd)`` each, no RoPE."""
    B, T, d = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ params["wk"].to(cfg.dtype).reshape(d, -1)).view(
        B, T, -1, hd)
    v = (enc_out @ params["wv"].to(cfg.dtype).reshape(d, -1)).view(
        B, T, -1, hd)
    return {"k": k, "v": v}


def cross_attention(params, x: torch.Tensor,
                    cross_kv: Dict[str, torch.Tensor],
                    cfg: ModelConfig) -> torch.Tensor:
    """``x (B, S, d)`` attends to all of ``cross_kv``'s encoder positions
    (flash kernel, non-causal, no window), at any ``S``."""
    B, S, d = x.shape
    q = (x @ params["wq"].to(cfg.dtype).reshape(d, -1)).view(
        B, S, -1, cfg.resolved_head_dim)
    o = flash_kernel.attention(q, cross_kv["k"], cross_kv["v"],
                               causal=False, window=0)
    return _out_proj(params, o, cfg)

"""Serving step factories: prefill, dense decode, the dense-mode batched
slot decode, fused paged decode, speculative verify and suffix prefill,
the prefill scatter, and the ``greedy_generate`` oracle. The prefill and
decode factories also take the audio enc-dec (``models.encdec``).

Counterpart of ``repro/serve/steps.py``. The reference's steps are jitted
with donated caches; here they are plain functions that queue work on the
current CUDA stream and update caches and the page pool in place, so the
stream orders every read after the writes before it.

The ``make_fused_*`` steps run the whole batch through ONE
``lm.lm_paged_decode`` call: the paged kernel walks each slot's page
table on device (attend + accept-masked KV write), with ``n_valid`` as the
write mask: 0 = idle slot, 1 = decode, ``1 + K`` = verify window, the
real tail length = suffix prefill. The decode, verify and dense-mode steps
have fixed shapes, so the engine captures them as CUDA graphs
(``serve.graphs``); everything they compute, the argmax and the verify's
accept count included, stays on the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models import encdec, lm
from repro_torch.models.common import AUDIO, ModelConfig
from repro_torch.util import resolve_device


def make_prefill_step(cfg: ModelConfig, max_cache_len: int) -> Callable:
    """(params, batch) → (next-token logits (B, 1, V), primed cache of
    ``max_cache_len`` positions). A VLM's batch carries ``patches`` beside
    its ``tokens``. The audio enc-dec's batch is ``{"audio_embed": (B,
    T_enc, frontend_dim)}``: the prefill encodes it, precomputes each
    decoder layer's cross-KV, and decodes a BOS (token 0) at position 0,
    so its state is the enc-dec decode state and its logits predict the
    first token."""
    if cfg.family == AUDIO:
        def prefill(params, batch):
            audio = batch["audio_embed"]
            state = encdec.init_decode_state(params, audio, cfg,
                                             max_cache_len)
            bos = torch.zeros((audio.shape[0], 1), dtype=torch.int32,
                              device=audio.device)
            return encdec.encdec_decode_step(params, bos, cfg, state, 0)
        return prefill

    def prefill(params, batch):
        tokens = batch["tokens"]
        cache = lm.init_cache(cfg, tokens.shape[0], max_cache_len,
                              device=tokens.device)
        return lm.lm_prefill(params, batch, cfg, cache)
    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, cache, token, pos) → (logits, cache updated in place); for
    the audio enc-dec the cache is its decode state."""
    if cfg.family == AUDIO:
        def decode(params, cache, token, pos):
            return encdec.encdec_decode_step(params, token, cfg, cache, pos)
        return decode

    def decode(params, cache, token, pos):
        return lm.lm_decode_step(params, token, cfg, cache, pos)
    return decode


def make_batched_decode_step(cfg: ModelConfig,
                             layers: Optional[list] = None) -> Callable:
    """Dense-mode slot decode: ``(params, caches, tokens (S,1,1),
    positions (S,) or None) → (next_tokens (S,1) int32, caches)``, one
    decode step over every slot with the greedy argmax in the step.
    ``caches`` is the layer-stacked per-slot cache with the S slots as its
    batch, updated in place. The reference vmaps a batch-1 decode over the
    slots; here one batch of S rows decodes at once, row ``s`` at
    ``positions[s]`` (a device tensor, never read on the host; the SSM
    family reads none). ``layers`` are ``lm.layer_views(params)`` computed
    once by the caller."""
    lm.require_ported(cfg)

    def step(params, caches, tokens, positions):
        logits, caches = lm.lm_decode_step(params, tokens[:, 0, :], cfg,
                                           caches, positions, layers=layers)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        return nxt, caches
    return step


def make_fused_paged_decode_step(cfg: ModelConfig, page_size: int,
                                 layers: Optional[list] = None) -> Callable:
    """(params, pool, tokens (S,1,1), positions (S,), tables (S,T),
    n_valid (S,)) → (next_tokens (S,1) int32, pool). One fused kernel
    pass for every slot, greedy argmax in the step. ``layers`` are
    ``lm.layer_views(params)`` computed once by the caller."""
    def step(params, pool, tokens, positions, tables, n_valid):
        logits, pool = lm.lm_paged_decode(
            params, tokens[:, 0, :], cfg, pool, positions, tables, n_valid,
            page_size=page_size, layers=layers)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        return nxt, pool
    return step


def make_fused_paged_verify_step(cfg: ModelConfig, page_size: int,
                                 n_draft: int,
                                 layers: Optional[list] = None) -> Callable:
    """Speculative verify on the fused kernel: ``(params, pool,
    tokens (S,1,1+K), positions (S,), tables (S,T), n_valid (S,))`` →
    ``(emitted (S,1+K) int32, accepts (S,) int32, pool)``.

    ``n_valid = 1 + k`` for a live slot with ``k`` drafts (0 idle) masks
    the KV writes inside the kernel: rows past it are written nowhere.
    ``emitted[s, j]`` is the greedy token after window row ``j``;
    ``accepts[s]`` counts the leading drafts equal to the token the model
    emitted before them, among the slot's ``k``. Rejected rows that were
    written sit past the advancing causal horizon until a later window
    overwrites them. ``layers`` are ``lm.layer_views(params)`` computed
    once by the caller."""
    K = int(n_draft)

    def step(params, pool, tokens, positions, tables, n_valid):
        tok = tokens[:, 0, :]                                # (S, 1+K)
        logits, pool = lm.lm_paged_decode(
            params, tok, cfg, pool, positions, tables, n_valid,
            page_size=page_size, layers=layers)
        emitted = torch.argmax(logits, dim=-1).to(torch.int32)
        k = torch.clamp(n_valid - 1, min=0)                  # live drafts
        ok = (tok[:, 1:] == emitted[:, :-1]) & (
            torch.arange(K, device=tok.device)[None, :] < k[:, None])
        accepts = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        return emitted, accepts.to(torch.int32), pool
    return step


def make_fused_paged_suffix_step(cfg: ModelConfig, page_size: int,
                                 layers: Optional[list] = None) -> Callable:
    """Chunked suffix prefill on the fused kernel: (params, pool,
    tokens (1,Sw), positions (1,), tables (1,T), n_valid (1,)) →
    (logits (1,Sw,V), pool). ``Sw`` is the page-padded tail, ``n_valid``
    its real length: padded rows are never written and the clamped causal
    horizon keeps them off unwritten positions; shared prefix pages are
    read, never written."""
    def step(params, pool, tokens, positions, tables, n_valid):
        return lm.lm_paged_decode(
            params, tokens, cfg, pool, positions, tables, n_valid,
            page_size=page_size, layers=layers)
    return step


def make_prefill_scatter(cfg: ModelConfig, page_size: int) -> Callable:
    """Copy a dense prefill cache into the pool in place: (pool,
    dense_cache, table (n,)) → pool. ``dense_cache`` leaves are
    (L, 1, n*page_size, KV, hd); page ``i`` of it goes to pool page
    ``table[i]``. Every entry must be a distinct page the request owns:
    ``index_copy_`` with repeated indices is not deterministic, so unlike
    the reference no entry may name the null page."""
    def scatter(pool, dense_cache, table):
        for name, p in pool.items():
            c = dense_cache[name]
            pages = c[:, 0].reshape((c.shape[0], -1, page_size)
                                    + tuple(c.shape[3:]))
            p.index_copy_(1, table, pages)
        return pool
    return scatter


def greedy_generate(cfg: ModelConfig, params: Dict[str, Any], prompt: Any,
                    n_tokens: int, max_cache_len: int,
                    device: Any = "cuda") -> torch.Tensor:
    """Greedy decoding oracle: prefill, then one dense decode step per
    token. ``prompt`` (B, P) ints; returns (B, n_tokens) int32 on
    ``device``. One sequence batch, prefilled once and decoded to the
    end: the reference the continuous-batching engine is held against."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)
    logits, cache = make_prefill_step(cfg, max_cache_len)(
        params, {"tokens": prompt})
    decode = make_decode_step(cfg)
    pos = prompt.shape[1]
    out = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)]
    for i in range(n_tokens - 1):
        logits, cache = decode(params, cache, out[-1][:, None], pos + i)
        out.append(torch.argmax(logits[:, -1], dim=-1).to(torch.int32))
    return torch.stack(out, dim=1)

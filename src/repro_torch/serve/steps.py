"""Serving step factories: prefill, dense decode, the dense-mode batched
slot decode, paged decode, speculative verify and suffix prefill (fused
and unfused), the prefill scatter, and the ``greedy_generate`` oracle.
The prefill and decode factories also take the audio enc-dec
(``models.encdec``).

Counterpart of ``repro/serve/steps.py``. The reference's steps are jitted
with donated caches; here they are plain functions that queue work on the
current CUDA stream and update caches and the page pool in place, so the
stream orders every read after the writes before it.

The ``make_fused_*`` steps run the whole batch through ONE
``lm.lm_paged_decode`` call: the paged kernel walks each slot's page
table on device (attend + accept-masked KV write), with ``n_valid`` as the
write mask: 0 = idle slot, 1 = decode, ``1 + K`` = verify window, the
real tail length = suffix prefill. The ``make_paged_*`` (unfused) steps
gather each slot's pages into a contiguous view, run the ordinary
``lm.lm_decode_step`` against it (the dense decode: the paged kernel on
the view in place, where the head_dim has an instantiation) and copy the
written pages back into the pool. The decode, verify and dense-mode
steps have fixed shapes, so the engine captures them as CUDA graphs
(``serve.graphs``); everything they compute, the argmax, the verify's
accept count and the unfused steps' page indices included, stays on the
device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models import encdec, lm
from repro_torch.models.common import AUDIO, ModelConfig
from repro_torch.serve.kv_cache import pages_for
from repro_torch.sharding import place_by_specs
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

    def prefill(params, batch, counts=None):
        tokens = batch["tokens"]
        cache = lm.init_cache(cfg, tokens.shape[0], max_cache_len,
                              device=tokens.device)
        # under a mesh the fresh cache is placed by its logical axes
        cache = place_by_specs(cache, lm.cache_specs(cfg))
        return lm.lm_prefill(params, batch, cfg, cache, counts)
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
    once by the caller; ``counts``, a dropless MoE's counters
    (``moe.moe_block``)."""
    lm.require_ported(cfg)

    def step(params, caches, tokens, positions, counts=None):
        logits, caches = lm.lm_decode_step(params, tokens[:, 0, :], cfg,
                                           caches, positions, layers=layers,
                                           counts=counts)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        return nxt, caches
    return step


# ------------------------------------------------------- unfused paged steps

def _gather_pages(pool: Dict[str, torch.Tensor], tables: torch.Tensor,
                  page_size: int) -> Dict[str, torch.Tensor]:
    """Page tables → contiguous per-row cache views.

    pool leaf (L, total_pages+1, page_size, KV, hd), ``tables`` (B, T) →
    a new tensor (L, B, T*page_size, KV, hd): the layer-stacked dense
    cache ``lm.lm_decode_step`` takes, the B rows as its batch (the
    reference gathers one slot at a time under ``vmap``). Null-padded table
    tails gather the scratch page, which the decode mask (idx <= pos)
    hides."""
    out = {}
    for name, p in pool.items():
        g = p[:, tables]                          # (L, B, T, ps, KV, hd)
        out[name] = g.reshape(g.shape[:2] + (-1,) + tuple(g.shape[4:]))
    return out


def _written_page(cache: Dict[str, torch.Tensor], positions: torch.Tensor,
                  page_size: int) -> Dict[str, torch.Tensor]:
    """The page holding each row's ``positions[b]`` out of the contiguous
    views: leaves (L, B, T*page_size, KV, hd) → (L, B, page_size, KV, hd).
    The page index is a gather on the device, never read on the host."""
    B = positions.shape[0]
    rows = torch.arange(B, device=positions.device)
    pi = positions.long() // page_size
    out = {}
    for name, c in cache.items():
        c6 = c.view(c.shape[:2] + (-1, page_size) + tuple(c.shape[3:]))
        out[name] = c6[:, rows, pi]
    return out


def make_paged_decode_step(cfg: ModelConfig, page_size: int, *,
                           return_tokens: bool = False,
                           layers: Optional[list] = None) -> Callable:
    """Unfused paged decode: (params, pool, tokens (S,1,1), positions (S,),
    tables (S,T)) → (logits (S,1,1,V), pool), one token for every slot;
    with ``return_tokens`` the greedy next tokens (S,1) int32 instead of
    the logits. Every slot's pages are gathered and decoded, idle ones
    too, and each slot's written page is copied back to the pool page its
    table names at ``positions // page_size``. An idle slot's table is all
    null and its position 0, so its write lands in the scratch page: the
    copy's targets repeat only there, where which write wins does not
    matter. ``layers`` are ``lm.layer_views(params)`` computed once by the
    caller."""
    def step(params, pool, tokens, positions, tables):
        S = tokens.shape[0]
        cache = _gather_pages(pool, tables, page_size)
        logits, cache = lm.lm_decode_step(params, tokens[:, 0, :], cfg,
                                          cache, positions, layers=layers)
        rows = torch.arange(S, device=tables.device)
        targets = tables[rows, positions.long() // page_size].long()
        pages = _written_page(cache, positions, page_size)
        for name, p in pool.items():
            p.index_copy_(1, targets, pages[name])
        if return_tokens:
            nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
            return nxt, pool
        return logits[:, None], pool
    return step


def make_paged_verify_step(cfg: ModelConfig, page_size: int, n_draft: int,
                           layers: Optional[list] = None) -> Callable:
    """Unfused speculative verify: ``(params, pool, tokens (S,1,1+K),
    positions (S,), tables (S,T), write_tables (S,W), n_drafts (S,))`` →
    ``(emitted (S,1+K) int32, accepts (S,) int32, pool)``, K = ``n_draft``
    and W = ``1 + ceil(K / page_size)``, the most pages a window of K+1
    positions spans.

    All K+1 rows of each slot decode against its gathered pages (causal
    mask per row); ``emitted[s, j]`` is the greedy token after row ``j``
    and ``accepts[s]`` the leading drafts equal to the token emitted
    before them, among the slot's ``n_drafts[s]``. The W pages from
    ``positions // page_size`` are copied to the pages ``write_tables``
    names (``PagePool.write_table``): rows of idle or still-verifying
    slots and entries past a request's footprint name the scratch page,
    so rejected tails there land nowhere real; rejected rows inside the
    footprint sit past the causal horizon until the next window
    overwrites them. ``tables`` must leave W - 1 pages of slack past any
    window start (the engine pads them with the null page)."""
    K = int(n_draft)
    W = 1 + pages_for(K, page_size)

    def step(params, pool, tokens, positions, tables, write_tables,
             n_drafts):
        S = tokens.shape[0]
        tok = tokens[:, 0, :]                                # (S, 1+K)
        cache = _gather_pages(pool, tables, page_size)
        logits, cache = lm.lm_decode_step(params, tok, cfg, cache,
                                          positions, layers=layers)
        emitted = torch.argmax(logits, dim=-1).to(torch.int32)
        ok = (tok[:, 1:] == emitted[:, :-1]) & (
            torch.arange(K, device=tok.device)[None, :] < n_drafts[:, None])
        accepts = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        idx = (positions.long() // page_size)[:, None] \
            + torch.arange(W, device=tok.device)[None, :]    # (S, W)
        rows = torch.arange(S, device=tok.device)[:, None]
        targets = write_tables.reshape(-1).long()
        for name, p in pool.items():
            c = cache[name]
            c6 = c.view(c.shape[:2] + (-1, page_size) + tuple(c.shape[3:]))
            pages = c6[:, rows, idx]                 # (L, S, W, ps, KV, hd)
            p.index_copy_(1, targets, pages.reshape(
                (c.shape[0], S * W) + tuple(pages.shape[3:])))
        return emitted, accepts.to(torch.int32), pool
    return step


def make_paged_suffix_step(cfg: ModelConfig, page_size: int,
                           layers: Optional[list] = None) -> Callable:
    """Unfused chunked suffix prefill for a prefix-cache hit: (params, pool,
    tokens (1,Sw), pos, gather_table (T,), scatter_table (T,)) →
    (logits (1,Sw,V), pool). The whole prompt tail (positions ``pos ..
    pos+Sw-1``) decodes in one call against the request's gathered pages;
    every page of the view is copied back to ``scatter_table``, which names
    only the request's owned pages (shared prefix pages and padding name
    the null page), so shared pages are read, never written. Owned pages
    the tail did not reach are copied back unchanged."""
    def step(params, pool, tokens, pos, gather_table, scatter_table):
        cache = _gather_pages(pool, gather_table[None], page_size)
        logits, cache = lm.lm_decode_step(params, tokens, cfg, cache, pos,
                                          layers=layers)
        targets = scatter_table.long()
        for name, p in pool.items():
            c = cache[name]
            p.index_copy_(1, targets, c[:, 0].reshape(
                (c.shape[0], -1, page_size) + tuple(c.shape[3:])))
        return logits, pool
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

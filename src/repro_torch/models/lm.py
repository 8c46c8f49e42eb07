"""Decoder-only language models of the dense and SSM families: init,
forward, prefill, decode and (dense) fused paged decode.

Counterpart of ``repro/models/lm.py`` for those families. Parameters are
a plain dict with the reference's layout: per-layer leaves stacked on a
leading L axis (``params["layers"]["attn"]["wq"]`` is ``(L, d, H, hd)``,
``params["layers"]["ssm"]["wx"]`` ``(L, d, inner)``), so
``models.convert.params_from_numpy`` carries the reference's weights over
unchanged. The reference's ``lax.scan`` over layers is a Python loop over
per-layer views here. KV caches, SSM states and the page pool are updated
in place. Parallel blocks (command-r: attention and MLP share one
pre-norm, no ``norm2``) follow the reference's ``_block_*``. MoE, hybrid
and VLM raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import DENSE, SSM, ModelConfig
from repro_torch.models.layers import (embed_tokens, lm_logits, mlp,
                                       rmsnorm, rope_tables)
from repro_torch.util import resolve_device

Params = Dict[str, Any]


def require_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port does not
    run yet (families other than dense and SSM, MoE, frontends)."""
    if cfg.family not in (DENSE, SSM) or cfg.moe is not None \
            or cfg.frontend_dim:
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported; see ROADMAP")


# ============================================================ initialization

def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * scale
            ).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Any = "cuda") -> Params:
    """Random weights from ``seed`` with the reference's shapes and scales
    (normal * fan_in^-1/2, ``wo`` of attention at (H*hd)^-1/2, embedding
    at 0.02, norm scales 1 in fp32). Draws come from a ``torch.Generator``
    on ``device``, so they are not the reference's numbers; tests carry
    the reference's weights over with ``convert.params_from_numpy``."""
    require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    if cfg.family == SSM:
        return _init_ssm_params(cfg, gen, dev)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    Hp, KVp, hd = cfg.padded_heads, cfg.padded_kv_heads, \
        cfg.resolved_head_dim
    pd = cfg.param_dtype
    wq = _normal(gen, (L, d, Hp, hd), d ** -0.5, pd, dev)
    wk = _normal(gen, (L, d, KVp, hd), d ** -0.5, pd, dev)
    wv = _normal(gen, (L, d, KVp, hd), d ** -0.5, pd, dev)
    wo = _normal(gen, (L, Hp, hd, d), (Hp * hd) ** -0.5, pd, dev)
    if Hp != cfg.n_heads or KVp != cfg.n_kv_heads:
        # zero q/o weights of padded head slots: the function is exactly
        # the unpadded architecture
        mask = torch.as_tensor(attn_mod.head_mask(cfg), device=dev)
        wq = wq * mask[None, None, :, None].to(pd)
        wo = wo * mask[None, :, None, None].to(pd)
    if KVp != cfg.n_kv_heads:
        wk[:, :, cfg.n_kv_heads:] = 0
        wv[:, :, cfg.n_kv_heads:] = 0
    ones = torch.ones((L, d), dtype=torch.float32, device=dev)
    embed = {"tokens": _normal(gen, (cfg.padded_vocab, d), 0.02, pd, dev)}
    if not cfg.tied_embeddings:
        embed["head"] = _normal(gen, (d, cfg.padded_vocab), d ** -0.5, pd,
                                dev)
    layers = {
        "norm1": {"scale": ones},
        "attn": {"wq": wq, "wk": wk, "wv": wv, "wo": wo},
        "mlp": {"wi": _normal(gen, (L, d, ff), d ** -0.5, pd, dev),
                "wg": _normal(gen, (L, d, ff), d ** -0.5, pd, dev),
                "wo": _normal(gen, (L, ff, d), ff ** -0.5, pd, dev)},
    }
    if not cfg.parallel_block:
        layers["norm2"] = {"scale": ones.clone()}
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": {"scale": torch.ones((d,), dtype=torch.float32,
                                           device=dev)},
    }


def _init_ssm_params(cfg: ModelConfig, gen: torch.Generator,
                     dev: torch.device) -> Params:
    d = cfg.d_model
    return {
        "embed": {"tokens": _normal(gen, (cfg.padded_vocab, d), 0.02,
                                    cfg.param_dtype, dev)},
        "layers": {
            "norm": {"scale": torch.ones((cfg.n_layers, d),
                                         dtype=torch.float32, device=dev)},
            "ssm": ssm_mod.init_ssm(gen, cfg, cfg.n_layers, dev),
        },
        "final_norm": {"scale": torch.ones((d,), dtype=torch.float32,
                                           device=dev)},
    }


def layer_views(params: Params) -> List[Dict[str, Any]]:
    """Per-layer parameter dicts, views into the stacked leaves."""
    def unbind(tree):
        if isinstance(tree, dict):
            parts = {k: unbind(v) for k, v in tree.items()}
            n = len(next(iter(parts.values())))
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return tree.unbind(0)
    return unbind(params["layers"])


# ================================================================== blocks

def _mlp_residual(lp, x, h, a, cfg: ModelConfig):
    """The block's second half after attention output ``a`` of pre-norm
    ``h``: a parallel block (command-r) feeds the MLP the same ``h``;
    otherwise the MLP reads ``norm2`` of the attention residual."""
    if cfg.parallel_block:
        return x + a + mlp(lp["mlp"], h)
    x = x + a
    return x + mlp(lp["mlp"], rmsnorm(lp["norm2"], x, cfg.norm_eps))


def _block_train(lp, x, cfg: ModelConfig, rope):
    if cfg.family == SSM:
        return x + ssm_mod.ssm_block(lp["ssm"], rmsnorm(
            lp["norm"], x, cfg.norm_eps), cfg)
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    a = attn_mod.attention_block(lp["attn"], h, cfg, rope=rope)
    return _mlp_residual(lp, x, h, a, cfg)


def _block_prefill(lp, x, cache, cfg: ModelConfig, rope):
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    a, cache = attn_mod.prefill_attention(lp["attn"], h, cfg, cache, rope)
    return _mlp_residual(lp, x, h, a, cfg), cache


def _block_decode(lp, x, cache, pos, cfg: ModelConfig, rope):
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    a, cache = attn_mod.decode_attention(lp["attn"], h, cfg, cache, pos,
                                         rope)
    return _mlp_residual(lp, x, h, a, cfg), cache


def _block_paged_decode(lp, x, k_pages, v_pages, cfg: ModelConfig,
                        positions, tables, n_valid, page_size: int, rope):
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    a, _, _ = attn_mod.paged_decode_attention(
        lp["attn"], h, cfg, k_pages, v_pages, positions, tables, n_valid,
        page_size=page_size, rope=rope)
    return _mlp_residual(lp, x, h, a, cfg)


def _block_ssm_prefill(lp, x, cache, cfg: ModelConfig):
    """SSM prefill: the chunked scan yields the final SSD and conv state,
    copied into the layer's cache views."""
    y, state = ssm_mod.ssm_block(lp["ssm"], rmsnorm(lp["norm"], x,
                                                    cfg.norm_eps), cfg,
                                 return_state=True)
    for name, t in state.items():
        cache[name].copy_(t)
    return x + y


def _block_ssm_decode(lp, x, cache, cfg: ModelConfig):
    y, _ = ssm_mod.ssm_decode_step(lp["ssm"], rmsnorm(lp["norm"], x,
                                                      cfg.norm_eps),
                                   cfg, cache)
    return x + y


def _layer_cache(cache: Dict[str, torch.Tensor], i: int
                 ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s views of a layer-stacked cache (KV or SSM state)."""
    return {name: t[i] for name, t in cache.items()}


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    if cfg.family == SSM:      # attention-free: no rotary tables
        return None
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


# ============================================================ public forward

def lm_forward(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    """Logits for the whole sequence (tests / generation without cache)."""
    require_ported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg)
    rope = _rope(cfg, torch.arange(tokens.shape[1], device=x.device)[None])
    for lp in layer_views(params):
        x = _block_train(lp, x, cfg, rope)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """Layer-stacked dense KV cache ``(L, batch, max_len, KV, hd)``, or for
    the SSM family the constant-size state ``{"ssm": (L, batch, H, P, N)
    fp32, "conv_x"/"conv_B"/"conv_C": (L, batch, W-1, C)}`` (``max_len``
    unused)."""
    require_ported(cfg)
    device = resolve_device(device)
    if cfg.family == SSM:
        return ssm_mod.init_ssm_state(cfg, batch, n_layers=cfg.n_layers,
                                      device=device)
    return attn_mod.init_kv_cache(cfg, batch, max_len,
                                  n_layers=cfg.n_layers, device=device)


def lm_prefill(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the prompt; returns (last-position logits (B, 1, V), the
    cache primed in place)."""
    require_ported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg)
    rope = _rope(cfg, torch.arange(tokens.shape[1], device=x.device)[None])
    for i, lp in enumerate(layer_views(params)):
        if cfg.family == SSM:
            x = _block_ssm_prefill(lp, x, _layer_cache(cache, i), cfg)
        else:
            x, _ = _block_prefill(lp, x, _layer_cache(cache, i), cfg, rope)
    x = rmsnorm(params["final_norm"], x[:, -1:, :].contiguous(),
                cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg), cache


def lm_decode_step(params: Params, token: torch.Tensor, cfg: ModelConfig,
                   cache: Dict[str, torch.Tensor], pos: Any,
                   layers: Optional[List[Dict[str, Any]]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode ``token`` (B, S1) at absolute positions ``pos ..`` against a
    dense cache, written in place; ``pos`` is an int for every row or a
    ``(B,)`` tensor of per-row positions (dense-mode serve slots), never
    read back on the host. The SSM family decodes one token (B, 1) per row
    from its state and reads no position. ``layers`` may pass
    ``layer_views(params)`` computed once by a caller that steps many
    times."""
    require_ported(cfg)
    x = embed_tokens(params["embed"], token, cfg)
    views = layers if layers is not None else layer_views(params)
    if cfg.family == SSM:
        for i, lp in enumerate(views):
            x = _block_ssm_decode(lp, x, _layer_cache(cache, i), cfg)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_logits(params["embed"], x, cfg), cache
    B, S1 = token.shape
    attn_mod.check_decode_span(cfg, cache["k"].shape[2], pos, S1)
    pos = attn_mod.row_positions(pos, B, x.device)
    rope = _rope(cfg, pos[:, None] + torch.arange(S1, device=x.device))
    for i, lp in enumerate(views):
        x, _ = _block_decode(lp, x, _layer_cache(cache, i), pos, cfg, rope)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg), cache


def lm_paged_decode(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                    pool: Dict[str, torch.Tensor], positions: torch.Tensor,
                    tables: torch.Tensor, n_valid: torch.Tensor, *,
                    page_size: int,
                    layers: Optional[List[Dict[str, Any]]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused paged decode over ALL serve slots in one call.

    ``tokens (S, W)`` int — each slot's query window (W=1 decode, W=padded
    tail for suffix prefill); ``pool`` the layer-stacked page pool
    ``{"k","v": (L, P+1, ps, KVp, hd)}``, updated in place layer by layer;
    ``positions``/``n_valid`` (S,) int32; ``tables`` (S, T) int32.
    ``layers`` may pass ``layer_views(params)`` computed once by a caller
    that steps many times. Returns ``(logits (S, W, vocab), pool)``.
    """
    require_ported(cfg)
    if cfg.family == SSM:
        raise NotImplementedError("paged decode requires KV attention")
    x = embed_tokens(params["embed"], tokens, cfg)
    W = tokens.shape[1]
    offs = torch.arange(W, device=x.device, dtype=positions.dtype)
    rope = _rope(cfg, positions[:, None] + offs[None, :])
    for i, lp in enumerate(layers if layers is not None
                           else layer_views(params)):
        x = _block_paged_decode(lp, x, pool["k"][i], pool["v"][i], cfg,
                                positions, tables, n_valid, page_size, rope)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg), pool

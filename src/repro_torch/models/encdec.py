"""Encoder-decoder backbone (whisper-large-v3): init, the encoder, the
teacher-forced decoder blocks, and cached decoding.

Counterpart of ``repro/models/encdec.py``. The conv audio frontend is a
stub, as in the reference: the inputs are precomputed frame embeddings
``(B, T_enc, frontend_dim)``, which ``frontend.proj`` maps to ``d_model``.
Encoder and decoder positions are fixed sinusoids (``rope_theta`` 0: no
rotary tables). Parameters keep the reference's nesting, with every layer
leaf stacked on a leading axis: ``encoder`` (``norm1``, ``attn``,
``norm2``, ``mlp``; ``n_enc_layers``) and ``decoder`` (``norm1``,
``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``, ``mlp``;
``n_dec_layers``), so ``models.convert.params_from_numpy`` carries the
reference's weights over unchanged.

The encoder's attention is the flash kernel, non-causal over the frames;
the cross-attention is the flash kernel against the encoder's keys at
every query length (one row a decode step); the decoder's self-attention
in a decode step is ``attention.decode_attention`` (the paged kernel
reading the self-attention cache in place, where the reference computes
it with einsums outside any Pallas kernel). The decode state is the
reference's layer-stacked layout, ``{"cross": {"k", "v": (L, B, T_enc,
KVp, hd)}, "self": {"k", "v": (L, B, max_len, KVp, hd)}}``; a decode step
writes the self-attention cache in place. ``param_specs`` is the
parameters' logical-axis tree (``repro_torch.sharding``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.common import AUDIO, ModelConfig
from repro_torch.models.layers import (cross_entropy, embed_tokens,
                                       embedding_specs, init_embedding,
                                       init_mlp, init_normal, init_rmsnorm,
                                       layer_views, lm_logits, mlp, mlp_specs,
                                       next_tokens, rmsnorm, rmsnorm_specs,
                                       sinusoidal_pe, sinusoidal_positions,
                                       stack_specs)
from repro_torch.sharding import constrain, is_dtensor, place_by_specs
from repro_torch.util import generator, resolve_device

Params = Dict[str, Any]
State = Dict[str, Dict[str, torch.Tensor]]


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Any = "cuda") -> Params:
    """Random weights from ``seed`` with the reference's shapes and scales
    (as ``lm.init_params``: normal * fan_in^-1/2, attention's ``wo`` at
    (H*hd)^-1/2, embedding at 0.02, norm scales 1 in fp32); padded head
    slots carry zero q/o and k/v weights. Draws come from a
    ``torch.Generator`` on ``device``; tests carry the reference's weights
    over with ``convert.params_from_numpy``."""
    if cfg.family != AUDIO:
        raise ValueError(f"{cfg.name} is family {cfg.family!r}, not an "
                         "audio encoder-decoder")
    dev = resolve_device(device)
    gen = generator(dev, seed)
    d, F = cfg.d_model, cfg.frontend_dim
    Le, Ld = (cfg.n_enc_layers,), (cfg.n_dec_layers,)
    return {
        "embed": init_embedding(cfg, gen, dev),
        "frontend": {"proj": init_normal(gen, (F, d), F ** -0.5,
                                         cfg.param_dtype, dev)},
        "encoder": {"norm1": init_rmsnorm(dev, *Le, d),
                    "attn": attn_mod.init_attention(cfg, gen, dev, lead=Le),
                    "norm2": init_rmsnorm(dev, *Le, d),
                    "mlp": init_mlp(cfg, gen, dev, d, cfg.d_ff, Le)},
        "enc_norm": init_rmsnorm(dev, d),
        "decoder": {"norm1": init_rmsnorm(dev, *Ld, d),
                    "self_attn": attn_mod.init_attention(cfg, gen, dev,
                                                         lead=Ld),
                    "norm_x": init_rmsnorm(dev, *Ld, d),
                    "cross_attn": attn_mod.init_attention(cfg, gen, dev,
                                                          lead=Ld),
                    "norm2": init_rmsnorm(dev, *Ld, d),
                    "mlp": init_mlp(cfg, gen, dev, d, cfg.d_ff, Ld)},
        "dec_norm": init_rmsnorm(dev, d),
    }


# ================================================================= encoder

def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    enc = {"norm1": rmsnorm_specs(), "attn": attn_mod.attention_specs(cfg),
           "norm2": rmsnorm_specs(), "mlp": mlp_specs()}
    dec = {"norm1": rmsnorm_specs(),
           "self_attn": attn_mod.attention_specs(cfg),
           "norm_x": rmsnorm_specs(),
           "cross_attn": attn_mod.attention_specs(cfg),
           "norm2": rmsnorm_specs(), "mlp": mlp_specs()}
    return {
        "embed": embedding_specs(cfg),
        "frontend": {"proj": ("fsdp", "tp")},
        "encoder": stack_specs(enc), "enc_norm": rmsnorm_specs(),
        "decoder": stack_specs(dec), "dec_norm": rmsnorm_specs(),
    }


def _enc_block(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    x = x + attn_mod.attention_block(lp["attn"], h, cfg, causal=False)
    h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], h, cfg.gather_weights)


def encode(params: Params, audio_embed: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """``audio_embed (B, T_enc, frontend_dim)`` (the stub frontend's
    output) → ``enc_out (B, T_enc, d_model)``."""
    x = audio_embed.to(cfg.dtype) @ params["frontend"]["proj"].to(cfg.dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(cfg.dtype)
    x = constrain(x, "batch", None, None)
    for lp in layer_views(params, "encoder"):
        x = _enc_block(lp, x, cfg)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# ================================================================= decoder

def _embed_dec(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
               pos0: Any = 0) -> torch.Tensor:
    """Token embeddings plus the sinusoid of each row's positions ``pos0
    ..``: ``pos0`` an int, or a ``(B,)`` device tensor of per-row
    positions (never read on the host)."""
    x = embed_tokens(params["embed"], tokens, cfg)
    B, S = tokens.shape
    offs = torch.arange(S, device=x.device)
    if isinstance(pos0, torch.Tensor):
        positions = attn_mod.row_positions(pos0, B, x.device)[:, None] + offs
    else:
        positions = offs + int(pos0)
    return constrain(x + sinusoidal_pe(positions, cfg.d_model).to(cfg.dtype),
                     "batch", None, None)


def _dec_block_train(lp, x: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """One decoder layer over a whole (teacher-forced) sequence: causal
    self-attention, cross-attention to ``enc_out``, MLP."""
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    x = x + attn_mod.attention_block(lp["self_attn"], h, cfg, causal=True)
    h = rmsnorm(lp["norm_x"], x, cfg.norm_eps)
    ckv = attn_mod.precompute_cross_kv(lp["cross_attn"], enc_out, cfg)
    x = x + attn_mod.cross_attention(lp["cross_attn"], h, ckv, cfg)
    h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    return x + mlp(lp["mlp"], h, cfg.gather_weights)


def encdec_logits(params: Params, audio_embed: torch.Tensor,
                  tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder logits ``(B, T_dec, V)`` of ``tokens`` over
    the encoded audio: the forward of the reference's ``encdec_loss``, and
    the oracle of cached decoding."""
    enc_out = encode(params, audio_embed, cfg)
    x = _embed_dec(params, tokens, cfg)
    for lp in layer_views(params, "decoder"):
        x = _dec_block_train(lp, x, enc_out, cfg)
    x = rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg)


def encdec_loss(params: Params, batch: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> torch.Tensor:
    """The training objective (the reference's ``encdec_loss``): ``batch``
    holds ``audio_embed (B, T_enc, F)`` and ``dec_tokens (B, T_dec)``;
    next-token cross-entropy of the teacher-forced decoder, the last
    position carrying no loss."""
    tokens = batch["dec_tokens"]
    logits = encdec_logits(params, batch["audio_embed"], tokens, cfg)
    valid = torch.ones(tokens.shape, dtype=torch.float32,
                       device=tokens.device)
    valid[:, -1] = 0.0
    return cross_entropy(logits, next_tokens(tokens), valid)


# ================================================================= serving

def init_decode_state(params: Params, audio_embed: torch.Tensor,
                      cfg: ModelConfig, max_len: int) -> State:
    """Encoder pass, each decoder layer's cross-KV, and an empty self-KV
    cache of ``max_len`` positions, all on ``audio_embed``'s device."""
    enc_out = encode(params, audio_embed, cfg)
    views = layer_views(params, "decoder")
    B, T = enc_out.shape[:2]
    self_kv = attn_mod.init_kv_cache(cfg, B, max_len, n_layers=len(views),
                                     device=enc_out.device)
    if is_dtensor(enc_out):
        # under a mesh: the layers' cross-KV stacked as they come, the
        # self-KV placed by its logical axes
        kvs = [attn_mod.precompute_cross_kv(lp["cross_attn"], enc_out, cfg)
               for lp in views]
        cross = {n: torch.stack([kv[n] for kv in kvs]) for n in ("k", "v")}
        return {"cross": cross, "self": place_by_specs(
            self_kv, attn_mod.kv_cache_specs(True, cfg))}
    shape = (len(views), B, T, cfg.padded_kv_heads, cfg.resolved_head_dim)
    cross = {"k": torch.empty(shape, dtype=cfg.dtype, device=enc_out.device),
             "v": torch.empty(shape, dtype=cfg.dtype, device=enc_out.device)}
    for i, lp in enumerate(views):
        kv = attn_mod.precompute_cross_kv(lp["cross_attn"], enc_out, cfg)
        cross["k"][i].copy_(kv["k"])
        cross["v"][i].copy_(kv["v"])
    return {"cross": cross, "self": self_kv}


def _layer(tree: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {name: t[i] for name, t in tree.items()}


def encdec_decode_step(params: Params, token: torch.Tensor, cfg: ModelConfig,
                       state: State, pos: Any,
                       layers: Optional[List[Dict[str, Any]]] = None
                       ) -> Tuple[torch.Tensor, State]:
    """Decode ``token (B, S1)`` at positions ``pos ..`` (an int, or a
    ``(B,)`` device tensor of per-row positions, never read on the host)
    against the self-KV cache, written in place, and the precomputed
    cross-KV. ``layers`` may pass ``layer_views(params, "decoder")``
    computed once by a caller that steps many times. Returns ``(logits
    (B, S1, V), state)``."""
    x = _embed_dec(params, token, cfg, pos0=pos)
    views = layers if layers is not None else layer_views(params, "decoder")
    B, S1 = token.shape
    pages = attn_mod.dense_pages(cfg, B, state["self"]["k"].shape[2], pos,
                                 S1, x.device)
    for i, lp in enumerate(views):
        h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        a, _ = attn_mod.decode_attention(lp["self_attn"], h, cfg,
                                         _layer(state["self"], i), pos,
                                         pages=pages)
        x = x + a
        h = rmsnorm(lp["norm_x"], x, cfg.norm_eps)
        x = x + attn_mod.cross_attention(lp["cross_attn"], h,
                                         _layer(state["cross"], i), cfg)
        h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
        x = x + mlp(lp["mlp"], h, cfg.gather_weights)
    x = rmsnorm(params["dec_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg), state

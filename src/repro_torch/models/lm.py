"""Decoder-only language models of the dense, MoE, SSM, hybrid and
moe_hybrid families: init, forward, prefill, decode and (dense and MoE)
fused paged decode.

Counterpart of ``repro/models/lm.py`` for those families. Parameters are
a plain dict with the reference's layout: per-layer leaves stacked on a
leading L axis (``params["layers"]["attn"]["wq"]`` is ``(L, d, H, hd)``,
``params["layers"]["ssm"]["wx"]`` ``(L, d, inner)``), so
``models.convert.params_from_numpy`` carries the reference's weights over
unchanged (for a hybrid it adds the projector the reference lacks, C.7).
The reference's ``lax.scan`` over layers is a Python loop over per-layer
views here. KV caches, SSM states and the page pool are updated in place.
Parallel blocks (command-r: attention and MLP share one pre-norm, no
``norm2``) follow the reference's ``_block_*``; an MoE block
(``models.moe``) takes the MLP's place. The hybrid (zamba2) runs a shared
attention block over ``concat(x, x0)`` at width ``2·d_model`` before every
``hybrid_attn_every``-th SSM layer, each site through its own output
projector (``_apply_hybrid``). The moe_hybrid family (granite-4.0-h, the
port's own: the reference has none) changes its mixer by layer: each
layer is rmsnorm, a Mamba-2 or an attention mixer (``cfg.layer_types``),
the residual times ``residual_multiplier``, rmsnorm, the MoE block (its
dispatch dropless), the residual again (``_apply_moe_hybrid``). Its
mixers' weights are stacks of their own, ``params["ssm"]`` over the
Mamba-2 layers and ``params["attn"]`` over the attention layers, in layer
order; ``params["layers"]`` holds each layer's two norms and its MoE. A
VLM (internvl2) is a dense decoder whose
``lm_forward`` and ``lm_prefill`` prepend ``batch["patches"] @
frontend.proj`` to the token embeddings (``_embed_inputs``); its decode
steps sit at ``n_patches + S`` onward. The audio enc-dec (whisper) has its
own model functions, ``models.encdec``: here it raises
``NotImplementedError``.

``lm_loss`` is the training objective (next-token cross-entropy over the
token positions; a VLM's patch rows carry no loss). Its layer body is
rematerialised as ``cfg.remat`` says (``_maybe_remat``): ``"full"``
recomputes the whole body in the backward (``torch.utils.checkpoint``),
``"dots"`` keeps the matmul outputs and recomputes the rest (selective
checkpointing), ``"none"`` saves everything; a hybrid's stack is never
rematerialised, as in the reference.

``param_specs`` and ``cache_specs`` are the logical-axis trees of the
parameters and of the dense cache (``repro_torch.sharding``), with the
reference's leaves on the port's always-stacked layout (its
``scan_layers=True``). Two places differ from the reference's trees as the
port's layout does: a hybrid's cache is one flat dict (the reference keeps
per-layer and per-site lists), and its ``proj`` stacks one projector per
site (C.7); each leaf keeps the reference's logical axes. The moe_hybrid
family's trees (no reference) are built from the same leaves' rules.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (AUDIO, DENSE, HYBRID, MOE,
                                       MOE_HYBRID, SSM, VLM, ModelConfig)
from repro_torch.models.layers import (cross_entropy, embed_tokens,
                                       embedding_specs, init_embedding,
                                       init_mlp, init_normal, init_rmsnorm,
                                       layer_views, lm_logits, mlp, mlp_specs,
                                       next_tokens, rmsnorm, rmsnorm_specs,
                                       stack_specs)
from repro_torch.sharding import constrain
from repro_torch.util import generator, resolve_device

Params = Dict[str, Any]


def require_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration these decoder-only
    functions do not run: the audio enc-dec (``models.encdec`` runs it), a
    family the port lacks, or a frontend outside the VLM family; a
    ``ValueError`` for a VLM without its patch frontend."""
    if cfg.family == AUDIO:
        raise NotImplementedError(
            f"{cfg.name} is an audio encoder-decoder: its model functions "
            "are repro_torch.models.encdec")
    if cfg.family not in (DENSE, MOE, SSM, HYBRID, MOE_HYBRID, VLM) or (
            cfg.frontend_dim and cfg.family != VLM):
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported; see ROADMAP")
    if cfg.family == VLM and not (cfg.frontend_dim and cfg.n_patches):
        raise ValueError(f"{cfg.name}: a VLM needs frontend_dim and "
                         "n_patches")


# ============================================================ initialization

def init_params(cfg: ModelConfig, seed: int = 0,
                device: Any = "cuda") -> Params:
    """Random weights from ``seed`` with the reference's shapes and scales
    (normal * fan_in^-1/2, ``wo`` of attention at (H*hd)^-1/2, embedding
    at 0.02, norm scales 1 in fp32; MoE as ``moe.init_moe``). A hybrid's
    shared block gets one projector per site (``cfg.hybrid_sites``), where
    the reference makes one fewer when ``hybrid_attn_every`` does not
    divide ``n_layers`` (C.7). A VLM gets the patch projector
    ``frontend.proj (frontend_dim, d_model)`` at frontend_dim^-1/2. Draws
    come from a ``torch.Generator`` on ``device``, so they are not the
    reference's numbers; tests carry the reference's weights over with
    ``convert.params_from_numpy``."""
    require_ported(cfg)
    dev = resolve_device(device)
    gen = generator(dev, seed)
    L, d = cfg.n_layers, cfg.d_model
    params = {"embed": init_embedding(cfg, gen, dev),
              "final_norm": init_rmsnorm(dev, d)}
    if cfg.family == MOE_HYBRID:
        params["layers"] = {"norm1": init_rmsnorm(dev, L, d),
                            "norm2": init_rmsnorm(dev, L, d),
                            "moe": moe_mod.init_moe(gen, cfg, L, dev)}
        params["ssm"] = ssm_mod.init_ssm(gen, cfg, cfg.n_mixers("mamba"),
                                         dev)
        params["attn"] = attn_mod.init_attention(
            cfg, gen, dev, d, (cfg.n_mixers("attention"),))
    elif cfg.family in (SSM, HYBRID):
        params["layers"] = {"norm": init_rmsnorm(dev, L, d),
                            "ssm": ssm_mod.init_ssm(gen, cfg, L, dev)}
    else:
        layers = {"norm1": init_rmsnorm(dev, L, d),
                  "attn": attn_mod.init_attention(cfg, gen, dev, d, (L,))}
        if cfg.family == MOE:
            layers["moe"] = moe_mod.init_moe(gen, cfg, L, dev)
        else:
            layers["mlp"] = init_mlp(cfg, gen, dev, d, cfg.d_ff, (L,))
        if not cfg.parallel_block:
            layers["norm2"] = init_rmsnorm(dev, L, d)
        params["layers"] = layers
    if cfg.family == HYBRID:
        w = 2 * d
        params["shared"] = {
            "norm1": init_rmsnorm(dev, w),
            "attn": attn_mod.init_attention(cfg, gen, dev, w),
            "norm2": init_rmsnorm(dev, w),
            "mlp": init_mlp(cfg, gen, dev, w, cfg.d_ff),
            # per-site output projectors 2d → d, at the reference's scale
            # (its ``_init_dense`` takes the first dimension as fan_in)
            "proj": init_normal(gen, (cfg.hybrid_sites, w, d),
                                cfg.hybrid_sites ** -0.5, cfg.param_dtype,
                                dev)}
    if cfg.family == VLM:
        F = cfg.frontend_dim
        params["frontend"] = {"proj": init_normal(
            gen, (F, d), F ** -0.5, cfg.param_dtype, dev)}
    return params


def _layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family == MOE_HYBRID:
        return {"norm1": rmsnorm_specs(), "norm2": rmsnorm_specs(),
                "moe": moe_mod.moe_specs(cfg)}
    if cfg.family in (SSM, HYBRID):
        return {"norm": rmsnorm_specs(), "ssm": ssm_mod.ssm_specs()}
    p = {"norm1": rmsnorm_specs(), "attn": attn_mod.attention_specs(cfg)}
    if not cfg.parallel_block:
        p["norm2"] = rmsnorm_specs()
    if cfg.family == MOE:
        p["moe"] = moe_mod.moe_specs(cfg)
    else:
        p["mlp"] = mlp_specs()
    return p


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "embed": embedding_specs(cfg),
        "layers": stack_specs(_layer_specs(cfg)),
        "final_norm": rmsnorm_specs(),
    }
    if cfg.family == MOE_HYBRID:
        specs["ssm"] = stack_specs(ssm_mod.ssm_specs(cfg.conv_bias))
        specs["attn"] = stack_specs(attn_mod.attention_specs(cfg))
    if cfg.family == HYBRID:
        specs["shared"] = {
            "norm1": rmsnorm_specs(), "attn": attn_mod.attention_specs(cfg),
            "norm2": rmsnorm_specs(), "mlp": mlp_specs(),
            "proj": (None, "fsdp", "tp"),
        }
    if cfg.family == VLM or cfg.frontend_dim:
        specs["frontend"] = {"proj": ("fsdp", "tp")}
    return specs


def cache_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The dense cache's logical axes, leaf by leaf of ``init_cache``."""
    if cfg.family == SSM:
        return ssm_mod.ssm_state_specs(layer_stacked=True)
    kv = attn_mod.kv_cache_specs(layer_stacked=True, cfg=cfg)
    if cfg.family in (HYBRID, MOE_HYBRID):
        return {**ssm_mod.ssm_state_specs(layer_stacked=True), **kv}
    return kv


# ================================================================== blocks

def _mlp_residual(lp, x, h, a, cfg: ModelConfig):
    """The block's second half after attention output ``a`` of pre-norm
    ``h``: a parallel block (command-r) feeds the MLP the same ``h``;
    otherwise the MLP, or the MoE block, reads ``norm2`` of the attention
    residual."""
    if cfg.parallel_block:
        return x + a + mlp(lp["mlp"], h, cfg.gather_weights)
    x = x + a
    h2 = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    if cfg.family == MOE:
        return x + moe_mod.moe_block(lp["moe"], h2, cfg)
    return x + mlp(lp["mlp"], h2, cfg.gather_weights)


def _block_train(lp, x, cfg: ModelConfig, rope):
    if cfg.family in (SSM, HYBRID):
        return x + ssm_mod.ssm_block(lp["ssm"], rmsnorm(
            lp["norm"], x, cfg.norm_eps), cfg)
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    a = attn_mod.attention_block(lp["attn"], h, cfg, rope=rope)
    return _mlp_residual(lp, x, h, a, cfg)


def _block_prefill(lp, x, cache, cfg: ModelConfig, rope):
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    a, cache = attn_mod.prefill_attention(lp["attn"], h, cfg, cache, rope)
    return _mlp_residual(lp, x, h, a, cfg), cache


def _block_decode(lp, x, cache, pos, cfg: ModelConfig, rope, pages):
    h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
    a, cache = attn_mod.decode_attention(lp["attn"], h, cfg, cache, pos,
                                         rope, pages)
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


#: the leaves of a hybrid cache stacked over layers, and over sites
_SSM_LEAVES = ("ssm", "conv_x", "conv_B", "conv_C")
_KV_LEAVES = ("k", "v")


def _layer_cache(cache: Dict[str, torch.Tensor], i: int,
                 names: Optional[Tuple[str, ...]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Index ``i``'s views of a stacked cache (KV or SSM state), of the
    leaves ``names`` (default: all): a hybrid's layer ``i`` reads
    ``_SSM_LEAVES``, its site ``i`` ``_KV_LEAVES``."""
    return {name: cache[name][i] for name in (names or cache)}


def _apply_hybrid(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  views: List[Dict[str, Any]], attend: Callable,
                  ssm_layer: Callable) -> torch.Tensor:
    """zamba2's stack (the reference's ``_apply_hybrid``): before every
    ``hybrid_attn_every``-th SSM layer, the shared transformer block over
    ``concat(x, x0)`` at width 2·d, added to ``x`` through the site's own
    projector. ``attend(attn_params, h, site)`` is the mode's attention
    (returning its output), ``ssm_layer(lp, x, i)`` the mode's SSM
    layer."""
    sh = params["shared"]
    x0 = x
    site = 0
    for i, lp in enumerate(views):
        if i % cfg.hybrid_attn_every == 0:
            w_in = torch.cat([x, x0], dim=-1)
            h = rmsnorm(sh["norm1"], w_in, cfg.norm_eps)
            w_mid = w_in + attend(sh["attn"], h, site)
            w_out = w_mid + mlp(sh["mlp"], rmsnorm(sh["norm2"], w_mid,
                                                   cfg.norm_eps))
            x = x + w_out @ sh["proj"][site].to(cfg.dtype)
            site += 1
        x = ssm_layer(lp, x, i)
    return x


def _apply_moe_hybrid(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      views: List[Dict[str, Any]], mix: Callable,
                      counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """granite-4.0-h's stack: layer ``i`` is ``x + r·mixer(rmsnorm(x))``,
    then ``x + r·moe(rmsnorm(x))``, ``r`` the residual multiplier.
    ``mix(kind, j, p, h)`` is the mode's mixer of kind ``"mamba"`` or
    ``"attention"``, the ``j``-th of its kind, with weights ``p``;
    ``counts`` the MoE blocks' counters (``moe.moe_block``)."""
    mixer_views = {"mamba": layer_views(params, "ssm"),
                   "attention": layer_views(params, "attn")}
    r = cfg.residual_multiplier
    for lp, (kind, j) in zip(views, cfg.mixers):
        h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        x = x + mix(kind, j, mixer_views[kind][j], h) * r
        h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
        x = x + moe_mod.moe_block(lp["moe"], h, cfg, counts) * r
    return x


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    if cfg.family == SSM:      # attention-free: no rotary tables
        return None
    return attn_mod._rope(cfg, positions)


def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings; a VLM prepends its projected patches
    ``batch["patches"] (B, n_patches, frontend_dim) @ frontend.proj``
    (the reference's ``_embed_inputs``), so the sequence is ``n_patches +
    S`` long."""
    x = embed_tokens(params["embed"], batch["tokens"], cfg)
    if cfg.family == VLM:
        px = batch["patches"].to(cfg.dtype) \
            @ params["frontend"]["proj"].to(cfg.dtype)
        x = torch.cat([px, x], dim=1)
    return constrain(x, "batch", None, None)


# ================================================================== remat

#: the ops whose outputs ``"dots"`` keeps: products without batch
#: dimensions (a layer's ``x @ W``), as the reference's
#: ``dots_with_no_batch_dims_saveable``
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op in _SAVED_DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` as ``cfg.remat`` rematerialises it in the backward: ``"none"``
    as it is, ``"full"`` recomputed whole, ``"dots"`` recomputed but for
    its matmul outputs (the reference's ``_maybe_remat``)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        context = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
        return lambda *args: torch_checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=context)
    if cfg.remat != "full":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    return lambda *args: torch_checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)


def _apply_layers(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  rope, remat: bool = False) -> torch.Tensor:
    """The whole-sequence layer stack (no cache); ``remat`` wraps each
    non-hybrid layer body in ``_maybe_remat``."""
    if cfg.family == MOE_HYBRID:
        def mix(kind, j, p, h):
            if kind == "attention":
                return attn_mod.attention_block(p, h, cfg, rope=rope)
            return ssm_mod.ssm_block(p, h, cfg)
        return _apply_moe_hybrid(params, x, cfg, layer_views(params), mix)
    if cfg.family == HYBRID:
        return _apply_hybrid(
            params, x, cfg, layer_views(params),
            lambda ap, h, site: attn_mod.attention_block(ap, h, cfg,
                                                         rope=rope),
            lambda lp, x, i: _block_train(lp, x, cfg, rope))
    body = lambda h, lp: _block_train(lp, h, cfg, rope)   # noqa: E731
    if remat:
        body = _maybe_remat(body, cfg)
    for lp in layer_views(params):
        x = body(x, lp)
    return x


# ============================================================ public forward

def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy over the token positions (the reference's
    ``lm_loss``): labels are the tokens rolled left, the last position
    carries no loss, and a VLM's ``n_patches`` patch rows none either."""
    require_ported(cfg)
    x = _embed_inputs(params, batch, cfg)
    rope = _rope(cfg, torch.arange(x.shape[1], device=x.device)[None])
    x = _apply_layers(params, x, cfg, rope, remat=True)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = lm_logits(params["embed"], x, cfg)
    if cfg.family == VLM:
        logits = logits[:, cfg.n_patches:, :]
    tokens = batch["tokens"]
    valid = torch.ones(tokens.shape, dtype=torch.float32,
                       device=tokens.device)
    valid[:, -1] = 0.0
    return cross_entropy(logits, next_tokens(tokens), valid)


def lm_forward(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    """Logits for the whole sequence (tests / generation without cache);
    a VLM's first ``n_patches`` rows are its patches'."""
    require_ported(cfg)
    x = _embed_inputs(params, batch, cfg)
    rope = _rope(cfg, torch.arange(x.shape[1], device=x.device)[None])
    x = _apply_layers(params, x, cfg, rope)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """Layer-stacked dense KV cache ``(L, batch, max_len, KV, hd)``, or for
    the SSM family the constant-size state ``{"ssm": (L, batch, H, P, N)
    fp32, "conv_x"/"conv_B"/"conv_C": (L, batch, W-1, C)}`` (``max_len``
    unused). A hybrid's is both in one flat dict: the SSM leaves stacked
    over its layers, ``"k"``/``"v"`` ``(sites, batch, max_len, KV, hd)``
    over its shared-block sites (the reference keeps per-layer and
    per-site lists); a moe_hybrid's the same, over its Mamba-2 layers and
    its attention layers. Every leaf has the batch on axis 1."""
    require_ported(cfg)
    device = resolve_device(device)
    if cfg.family == MOE_HYBRID:
        cache = ssm_mod.init_ssm_state(cfg, batch,
                                       n_layers=cfg.n_mixers("mamba"),
                                       device=device)
        cache.update(attn_mod.init_kv_cache(
            cfg, batch, max_len, n_layers=cfg.n_mixers("attention"),
            device=device))
        return cache
    if cfg.family in (SSM, HYBRID):
        cache = ssm_mod.init_ssm_state(cfg, batch, n_layers=cfg.n_layers,
                                       device=device)
        if cfg.family == HYBRID:
            cache.update(attn_mod.init_kv_cache(
                cfg, batch, max_len, n_layers=cfg.hybrid_sites,
                device=device))
        return cache
    return attn_mod.init_kv_cache(cfg, batch, max_len,
                                  n_layers=cfg.n_layers, device=device)


def lm_prefill(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, cache: Dict[str, torch.Tensor],
               counts: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the prompt; returns (last-position logits (B, 1, V), the
    cache primed in place). A VLM's cache holds its ``n_patches`` patch
    rows ahead of the prompt, so its decode starts at ``n_patches + S``.
    A moe_hybrid's MoE blocks add to ``counts`` (``moe.moe_block``)."""
    require_ported(cfg)
    x = _embed_inputs(params, batch, cfg)
    rope = _rope(cfg, torch.arange(x.shape[1], device=x.device)[None])
    if cfg.family == MOE_HYBRID:
        def mix(kind, j, p, h):
            if kind == "attention":
                return attn_mod.prefill_attention(
                    p, h, cfg, _layer_cache(cache, j, _KV_LEAVES), rope)[0]
            y, state = ssm_mod.ssm_block(p, h, cfg, return_state=True)
            layer = _layer_cache(cache, j, _SSM_LEAVES)
            for name, t in state.items():
                layer[name].copy_(t)
            return y
        x = _apply_moe_hybrid(params, x, cfg, layer_views(params), mix,
                              counts)
    elif cfg.family == HYBRID:
        x = _apply_hybrid(
            params, x, cfg, layer_views(params),
            lambda ap, h, site: attn_mod.prefill_attention(
                ap, h, cfg, _layer_cache(cache, site, _KV_LEAVES), rope)[0],
            lambda lp, x, i: _block_ssm_prefill(
                lp, x, _layer_cache(cache, i, _SSM_LEAVES), cfg))
    elif cfg.family == SSM:
        for i, lp in enumerate(layer_views(params)):
            x = _block_ssm_prefill(lp, x, _layer_cache(cache, i), cfg)
    else:
        for i, lp in enumerate(layer_views(params)):
            x, _ = _block_prefill(lp, x, _layer_cache(cache, i), cfg, rope)
    x = rmsnorm(params["final_norm"], x[:, -1:, :].contiguous(),
                cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg), cache


def lm_decode_step(params: Params, token: torch.Tensor, cfg: ModelConfig,
                   cache: Dict[str, torch.Tensor], pos: Any,
                   layers: Optional[List[Dict[str, Any]]] = None,
                   counts: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode ``token`` (B, S1) at absolute positions ``pos ..`` against a
    dense cache, written in place; ``pos`` is an int for every row or a
    ``(B,)`` tensor of per-row positions (dense-mode serve slots), never
    read back on the host. The SSM family decodes one token (B, 1) per row
    from its state and reads no position; a hybrid decodes one token per
    row, its shared-block sites at ``pos``, and a moe_hybrid its attention
    layers at ``pos``. ``layers`` may pass
    ``layer_views(params)`` computed once by a caller that steps many
    times; a moe_hybrid's MoE blocks add to ``counts``."""
    require_ported(cfg)
    x = embed_tokens(params["embed"], token, cfg)
    views = layers if layers is not None else layer_views(params)
    if cfg.family == SSM:
        for i, lp in enumerate(views):
            x = _block_ssm_decode(lp, x, _layer_cache(cache, i), cfg)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return lm_logits(params["embed"], x, cfg), cache
    B, S1 = token.shape
    L = cache["k"].shape[2]
    attn_mod.check_decode_span(cfg, L, pos, S1)
    pos = attn_mod.row_positions(pos, B, x.device)
    rope = _rope(cfg, pos[:, None] + torch.arange(S1, device=x.device))
    pages = attn_mod.dense_pages(cfg, B, L, pos, S1, x.device)
    if cfg.family == MOE_HYBRID:
        def mix(kind, j, p, h):
            if kind == "attention":
                return attn_mod.decode_attention(
                    p, h, cfg, _layer_cache(cache, j, _KV_LEAVES), pos, rope,
                    pages)[0]
            return ssm_mod.ssm_decode_step(
                p, h, cfg, _layer_cache(cache, j, _SSM_LEAVES))[0]
        x = _apply_moe_hybrid(params, x, cfg, views, mix, counts)
    elif cfg.family == HYBRID:
        x = _apply_hybrid(
            params, x, cfg, views,
            lambda ap, h, site: attn_mod.decode_attention(
                ap, h, cfg, _layer_cache(cache, site, _KV_LEAVES), pos,
                rope, pages)[0],
            lambda lp, x, i: _block_ssm_decode(
                lp, x, _layer_cache(cache, i, _SSM_LEAVES), cfg))
    else:
        for i, lp in enumerate(views):
            x, _ = _block_decode(lp, x, _layer_cache(cache, i), pos, cfg,
                                 rope, pages)
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
    if cfg.family in (SSM, HYBRID, MOE_HYBRID):
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

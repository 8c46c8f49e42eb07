"""GQA attention for the dense decoder: prefill, dense decode and fused
paged decode, with RoPE and head padding.

Counterpart of ``repro/models/attention.py`` (``head_mask``,
``init_kv_cache``, ``_project_qkv``, ``prefill_attention``,
``decode_attention``, ``paged_decode_attention``, and the enc-dec's
``precompute_cross_kv`` and ``cross_attention``). Weights keep the
reference's layouts: ``wq`` ``(d, H, hd)``, ``wk``/``wv`` ``(d, KV, hd)``,
``wo`` ``(H, hd, d)``. Every softmax scales q·k by ``cfg.attn_scale``
(head_dim^-1/2, or granite's ``attention_multiplier``); a config without
rotary positions (``rope_theta`` 0: whisper, granite's NoPE) gets no
tables. Prefill attention is the flash kernel; paged decode the paged
kernel. Dense decode is the paged kernel too, reading the dense
cache in place as a pool whose row ``b`` owns pages ``b·T .. b·T + T - 1``
(``dense_pages``); where it cannot, it is grouped PyTorch matmuls, as the
reference computes it with einsums outside any Pallas kernel: the
sliding-window ring, q under a mesh (a DTensor), and head_dims the paged
kernel has no instantiation for. Cross-attention runs the flash kernel
non-causally against the encoder's keys, at every query length (``Sq = 1``
at each decode step).

Under a mesh (``repro_torch.sharding``) the reference's ``constrain`` and
``gathered`` sites place the activations; the flash kernel then runs on
each rank's shard, which must hold whole head_dims and whole KV groups:
q heads ``[r·H/m, (r+1)·H/m)`` with their own KV heads (``_kv_for_heads``).

The sliding-window cache is a ring of ``L`` slots: absolute position ``p``
lives in slot ``p % L``, after prefill as after decode. The reference's
prefill keeps the last ``L`` prompt keys at slots ``0..L-1``, which its
decode reads as ring slots only when ``S % L == 0`` (ROADMAP C.6); the
port rolls them into place.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import paged_attention as paged_kernel
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_rope_tables, gathered,
                                       init_normal, rope_tables)
from repro_torch.sharding import axis_size, constrain, is_dtensor
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


def _hd_ax(cfg: Optional[ModelConfig]) -> Optional[str]:
    # kv heads < TP degree → shard head_dim instead, IF it divides 16
    # (danube's head_dim=120 does not: its small kv weights replicate on tp)
    return "tp" if cfg is None or cfg.resolved_head_dim % 16 == 0 else None


def attention_specs(cfg: ModelConfig = None) -> Dict[str, Any]:
    hd_ax = _hd_ax(cfg)
    return {
        "wq": ("fsdp", "heads", None),
        "wk": ("fsdp", None, hd_ax),
        "wv": ("fsdp", None, hd_ax),
        "wo": ("heads", None, "fsdp"),
    }


def kv_cache_specs(layer_stacked: bool,
                   cfg: ModelConfig = None) -> Dict[str, Any]:
    hd_ax = _hd_ax(cfg)
    lead = (None,) if layer_stacked else ()
    return {"k": lead + ("batch", "kv_seq", None, hd_ax),
            "v": lead + ("batch", "kv_seq", None, hd_ax)}


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
    g = cfg.gather_weights
    hd_ax = _hd_ax(cfg)
    wq = gathered(params["wq"], None, "heads", None, gather=g)
    wk = gathered(params["wk"], None, None, hd_ax, gather=g)
    wv = gathered(params["wv"], None, None, hd_ax, gather=g)
    q = _project(x, wq, cfg)
    k = _project(x, wk, cfg)
    v = _project(x, wv, cfg)
    if cfg.rope_theta > 0:
        cos, sin = rope
        q = apply_rope_tables(q, cos, sin, lean=cfg.lean_attention)
        k = apply_rope_tables(k, cos, sin, lean=cfg.lean_attention)
    q = constrain(q, "batch", None, "act_heads", None)
    return q, k, v


def _project(x: torch.Tensor, w: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """``x (B, S, d) · w (d, n, hd)`` → ``(B, S, n, hd)``: one matmul on
    the flattened heads. A head_dim split over ranks (the ``tp`` rule of
    ``wk``/``wv``) does not flatten into the heads: one product a head."""
    w = w.to(cfg.dtype)
    if is_dtensor(w) and any(p.is_shard(2) for p in w.placements):
        return torch.stack([x @ w[:, i] for i in range(w.shape[1])], dim=2)
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, S, -1, w.shape[-1])


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                  heads: str = "act_heads"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V placed for the flash kernel beside q's heads (named ``heads``,
    as q's constraint names them): whole head_dims, and each rank's KV
    heads those of its q heads. Where the KV heads do not split as the q
    heads do, they are repeated to the q heads first, as the reference
    repeats them for its XLA attention. Without a mesh k and v stay as
    they are."""
    if not is_dtensor(k):
        return k, v
    m = axis_size(heads)
    groups = cfg.padded_kv_groups
    if groups > 1 and cfg.padded_kv_heads % m:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    return (constrain(k, "batch", None, heads, None),
            constrain(v, "batch", None, heads, None))


def _out_proj(params, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    o = constrain(o, "batch", None, "act_heads", None)
    wo = gathered(params["wo"], "heads", None, None,
                  gather=cfg.gather_weights).to(cfg.dtype)
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def attention_block(params, x: torch.Tensor, cfg: ModelConfig, *,
                    rope: Optional[Rope] = None,
                    causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (forward without cache)."""
    if rope is None:
        rope = _rope(cfg, torch.arange(x.shape[1], device=x.device)[None])
    q, k, v = _project_qkv(params, x, cfg, rope)
    k, v = _kv_for_heads(k, v, cfg)
    o = flash_kernel.attention(q, k, v, causal=causal, window=cfg.window,
                               scale=cfg.attn_scale)
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
    kr, vr = _kv_for_heads(k, v, cfg)
    o = flash_kernel.attention(q, kr, vr, causal=True, window=cfg.window,
                               scale=cfg.attn_scale)
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


def _write_rows(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor, slots: torch.Tensor) -> None:
    """Write the new rows ``k``/``v (B, S1, KV, hd)`` into ``cache`` at
    ``slots (B, S1)``, in place."""
    _write(cache["k"], k, slots)
    _write(cache["v"], v, slots)


def _write(c: torch.Tensor, new: torch.Tensor, slots: torch.Tensor) -> None:
    """An indexed write of ``new`` into ``c``. Under a mesh (a DTensor
    cache) the new rows move to the cache's placements, never the cache,
    and each rank writes its own shard; a cache sharded along its
    positions (the decode rules' ``kv_seq``) takes a select against its
    slot index instead, one new row at a time (the counterpart of the
    reference's ``dynamic_update_slice``)."""
    B, S1 = slots.shape
    if not is_dtensor(c):
        rows = torch.arange(B, device=slots.device)[:, None].expand(B, S1)
        c[rows, slots] = new
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = c.device_mesh
    new = new.redistribute(mesh, tuple(
        Replicate() if p.is_shard(1) else p for p in c.placements))
    if any(p.is_shard(1) and mesh.size(i) > 1
           for i, p in enumerate(c.placements)):
        idx = torch.arange(c.shape[1], device=slots.device)
        out = c
        for j in range(S1):
            hit = (idx[None, :] == slots[:, j:j + 1])[:, :, None, None]
            out = torch.where(hit, new[:, j:j + 1], out)
        c.copy_(out)
        return
    # each rank's slots are its own rows'
    slots = DTensor.from_local(
        slots, mesh, [Replicate()] * mesh.ndim, run_check=False
    ).redistribute(mesh, tuple(Shard(0) if p.is_shard(0) else Replicate()
                               for p in c.placements))
    _write(c.to_local(), new.to_local(), slots.to_local())


class DensePages(NamedTuple):
    """A dense cache ``(B, L, KV, hd)`` read as the paged kernel's pool
    ``(B·T, page_size, KV, hd)``, ``T = L / page_size``: row ``b``'s table
    names its own pages ``b·T .. b·T + T - 1`` in order, so the kernel
    reads each row's positions in place and writes its new rows itself."""
    tables: torch.Tensor       # (B, T) int32
    positions: torch.Tensor    # (B,) int32: each row's first new position
    n_valid: torch.Tensor      # (B,) int32: S1 for every row
    page_size: int


def dense_pages(cfg: ModelConfig, batch: int, L: int, pos: Any, S1: int,
                device: torch.device) -> Optional[DensePages]:
    """The page index of a dense cache of ``L`` positions for a decode of
    ``S1`` tokens a row at ``pos`` (as ``decode_attention`` takes it), or
    None where the decode keeps ``_grouped``: a sliding-window ring, whose
    slots are not causal by position, or a head_dim the paged kernel has
    no instantiation for. A step builds it once for all its sites.

    The page size is the largest power of two dividing ``L``, at most the
    kernel's split of ``SPLIT_LEN`` positions, whose table entries the
    kernel stages beside the split. Nothing is read back on the host, so
    the index is built inside a captured step graph too."""
    if cfg.window or cfg.resolved_head_dim not in paged_kernel.HEAD_DIMS:
        return None
    ps = min(L & -L, paged_kernel.SPLIT_LEN)
    T = L // ps
    return DensePages(
        tables=torch.arange(batch * T, dtype=torch.int32,
                            device=device).view(batch, T),
        positions=row_positions(pos, batch, device).to(torch.int32),
        n_valid=torch.full((batch,), S1, dtype=torch.int32, device=device),
        page_size=ps)


def decode_attention(params, x: torch.Tensor, cfg: ModelConfig,
                     cache: Dict[str, torch.Tensor], pos: Any,
                     rope: Optional[Rope] = None,
                     pages: Optional[DensePages] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode ``S1`` new tokens per row, row ``b`` at absolute positions
    ``pos[b] .. pos[b]+S1-1`` (``pos`` an int or a ``(B,)`` tensor), against
    a dense cache (B, L, KV, hd), written in place; ``pages`` may pass
    ``dense_pages`` of the same call, built once by a step of many sites.

    Where ``dense_pages`` gives an index and q's heads are whole on this
    process (no DTensor), the paged kernel reads the cache in place and
    writes the new rows. Otherwise: grouped-einsum GQA (the cache is never
    repeated to the q-head count), fp32 softmax with the ``-1e30`` mask.

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
    if pages is None:
        pages = dense_pages(cfg, B, L, pos, S1, dev)
    if pages is not None and not is_dtensor(q):
        return _paged_in_place(params, q, k, v, cache, pages, cfg), cache
    # the remainder wraps the ring and keeps any other write in bounds
    slots = qpos % L
    _write_rows(cache, k, v, slots)
    q = constrain(q, "batch", None, "act_heads", None)
    ck = constrain(cache["k"], "batch", "kv_seq", None, None)
    cv = constrain(cache["v"], "batch", "kv_seq", None, None)
    idx = torch.arange(L, device=dev)
    if cfg.window:
        p = qpos[:, :1]                                         # (B, 1)
        held = idx[None, :] + torch.div(p - idx[None, :], L,
                                        rounding_mode="floor") * L
        valid = ((held >= 0) & (held <= p)
                 & (held > p - cfg.window))[:, None, :]         # (B, 1, L)
    else:
        valid = idx[None, None, :] <= qpos[:, :, None]          # (B, S1, L)
    if is_dtensor(q) and any(p.is_shard(2) for p in q.placements):
        o = _grouped_shards(q, ck, cv, valid, cfg)
    else:
        o = _grouped(q, ck, cv, valid, cfg)
    return _out_proj(params, o, cfg), cache


def _paged_in_place(params, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cache: Dict[str, torch.Tensor],
                    pages: DensePages, cfg: ModelConfig) -> torch.Tensor:
    """The paged kernel over the cache viewed as its pool: it writes the
    new rows ``k``/``v (B, S1, KV, hd)`` and attends each row's positions
    up to its own. ``.view`` raises on a cache it cannot view in place,
    where ``.reshape`` would copy and the writes would go to the copy.

    The engine steps an idle slot at position 0 and a draining one past
    its request's end, which may pass ``L``; the kernel clamps a write's
    table entry to the row's last, so with these tables every write stays
    in the row's own pages, as ``qpos % L`` keeps ``_grouped``'s there."""
    B, L, KV, hd = cache["k"].shape
    ps = pages.page_size
    k_pool = cache["k"].view(B * L // ps, ps, KV, hd)
    v_pool = cache["v"].view(B * L // ps, ps, KV, hd)
    o, _, _ = paged_kernel.paged_attention(
        q, k, v, k_pool, v_pool, pages.tables, pages.positions,
        pages.n_valid, page_size=ps, scale=cfg.attn_scale)
    return _out_proj(params, o.to(cfg.dtype), cfg)


def _grouped(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
             valid: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Grouped-einsum GQA of ``q (B, S1, H, hd)`` over a cache ``ck, cv
    (B, L, KV, hd)`` where ``valid (B|1, S1|1, L)``: ``(B, S1, H, hd)``."""
    B, S1, H, _ = q.shape
    KV = ck.shape[2]
    qg = q.reshape(B, S1, KV, H // KV, -1)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, ck).float() \
        * cfg.attn_scale
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", probs, cv)
    return o.reshape(B, S1, H, -1)


def _grouped_shards(q, ck, cv, valid, cfg):
    """``_grouped`` of a DTensor ``q`` whose heads are split over ranks
    (the ``prefill`` rules: the cache's length whole), on each rank's
    shard: the einsum would flatten the split batch and head dims into
    one, which DTensor refuses in some torch releases. The cache and
    ``valid`` are placed on q's rows and heads first (a local slice where
    they are whole)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import _shards
    _shards.check("decode_attention", "q", q, (0, 2))
    mesh = q.device_mesh

    def placed(t, want):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        if tuple(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local()

    kv_place = tuple(p if p.is_shard() else Replicate()
                     for p in q.placements)
    rows = tuple(Shard(0) if p.is_shard(0) and valid.shape[0] > 1
                 else Replicate() for p in q.placements)
    o = _grouped(q.to_local(), placed(ck, kv_place), placed(cv, kv_place),
                 placed(valid, rows), cfg)
    return _shards.wrap(o, q, q.shape)


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
    q = constrain(q, "batch", None, "act_heads", None)
    o, k_pages, v_pages = paged_kernel.paged_attention(
        q, k, v, k_pages, v_pages, tables, positions, n_valid,
        page_size=page_size, scale=cfg.attn_scale)
    return _out_proj(params, o.to(cfg.dtype), cfg), k_pages, v_pages


# ------------------------------------------------------------ cross-attn
def precompute_cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig
                        ) -> Dict[str, torch.Tensor]:
    """The encoder output's keys and values for one decoder layer:
    contiguous ``(B, T_enc, KVp, hd)`` each, no RoPE."""
    return {"k": _project(enc_out, params["wk"], cfg),
            "v": _project(enc_out, params["wv"], cfg)}


def cross_attention(params, x: torch.Tensor,
                    cross_kv: Dict[str, torch.Tensor],
                    cfg: ModelConfig) -> torch.Tensor:
    """``x (B, S, d)`` attends to all of ``cross_kv``'s encoder positions
    (flash kernel, non-causal, no window), at any ``S``."""
    q = constrain(_project(x, params["wq"], cfg), "batch", None, "heads",
                  None)
    k, v = _kv_for_heads(cross_kv["k"], cross_kv["v"], cfg, "heads")
    o = flash_kernel.attention(q, k, v, causal=False, window=0)
    return _out_proj(params, o, cfg)

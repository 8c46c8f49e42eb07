"""Mixture-of-Experts block: router, dispatch, per-expert SwiGLU, combine,
and the optional shared expert.

Counterpart of ``repro/models/moe.py``, with both of its dispatch modes
over one ``(expert, capacity)`` buffer:

* ``"einsum"`` — GShard one-hot dispatch and combine products (what the
  reference's configurations use);
* ``"scatter"`` — the same buffer built by indexing, no dispatch products.

A routing group is one of the input's leading ``B`` rows, as in the
reference: the capacity is ``expert_capacity(cfg, S)`` and assignments past
it are dropped in (s, k) order. So the same tokens routed in other groups
(a whole prompt, one decode token, a padded suffix window) may drop other
assignments (ROADMAP C.8).

The port's third mode, ``"dropless"`` (granite-4.0-h, which the
reference lacks), drops nothing: the router runs in ``router_dtype`` and
takes each token's gates as the softmax of its top-k logits; the T·k
assignments are sorted by expert (a stable sort, so each expert's rows
stay in (token, k) order) at a size fixed by the shapes; each expert's
SwiGLU runs over its contiguous rows as three grouped products
(``grouped_mm``: ``torch._grouped_mm`` on the card, bf16 only; a loop
over the experts on the CPU); each token's k outputs are summed by its gates in
one fixed-order product, so the result is deterministic.

The reference computes the block with einsums outside any Pallas kernel;
here they are batched matmuls. Nothing reads back to the host or allocates
by data: the one-hots are comparisons with an ``arange`` and the positions
an exclusive cumsum; the dropless sort, its offsets (a ``searchsorted``)
and the grouped products are sized by T·k alone. So the block runs inside
a captured decode graph.

A dropless block given ``counts``, a ``(3,)`` int64 tensor on its
device, adds its call, its rows (assignments) and the experts that
received a row to it, with no readback, so a captured step's replays
count too (``obs.events.MOE_COUNTERS``).

``moe_specs`` is the weights' logical-axis tree (experts over the model
axis); the reference's ``constrain`` sites are kept, each on the
reference's layout of its tensor (``_constrain_as``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import gathered, init_normal, mlp, mlp_specs
from repro_torch.sharding import constrain, is_dtensor

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             device: Any) -> Params:
    """Layer-stacked MoE weights ``(n_layers, ...)`` with the reference's
    leaves, dtypes and scales: its ``_init_dense`` draws normal * fan_in^-1/2
    with fan_in the first dimension, which for the expert stacks ``wi``/
    ``wg`` ``(E, d, d_ff)`` is the expert count; ``wo`` ``(E, d_ff, d)`` at
    d_ff^-1/2; the router ``(d, E)`` in fp32."""
    m = cfg.moe
    d, E, pd = cfg.d_model, m.n_experts, cfg.param_dtype

    def dense(shape, dtype=pd, scale=None):
        scale = shape[0] ** -0.5 if scale is None else scale
        return init_normal(gen, (n_layers,) + shape, scale, dtype, device)

    p = {"router": dense((d, E), torch.float32),
         "wi": dense((E, d, m.d_ff)), "wg": dense((E, d, m.d_ff)),
         "wo": dense((E, m.d_ff, d), scale=m.d_ff ** -0.5)}
    if m.shared_d_ff:
        f = m.shared_d_ff
        p["shared"] = {"wi": dense((d, f)), "wg": dense((d, f)),
                       "wo": dense((f, d))}
    return p


def moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    p = {
        "router": ("fsdp", None),
        "wi": ("expert", "fsdp", None),
        "wg": ("expert", "fsdp", None),
        "wo": ("expert", None, "fsdp"),
    }
    if cfg.moe.shared_d_ff:
        p["shared"] = mlp_specs()
    return p


def _constrain_as(t: torch.Tensor, shape: Tuple[int, ...],
                  *axes) -> torch.Tensor:
    """``constrain`` of ``t`` viewed as ``shape`` (the reference's layout
    of the tensor), returned in ``t``'s own shape; a no-op without a
    mesh."""
    if not is_dtensor(t):
        return t
    return constrain(t.reshape(shape), *axes).reshape(t.shape)


def expert_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    cap = int(tokens_per_group * m.top_k / m.n_experts * m.capacity_factor)
    cap = max(cap, 1)
    return cap + (-cap) % 4 if cap > 4 else cap


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``idx (...)`` → ``(..., n)``; an index outside ``[0, n)`` gives a
    zero row (as ``jax.nn.one_hot``), and nothing is checked on the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(params: Params, x: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router in ``router_dtype``: softmax, top-k, gates renormalised.
    ``x (B, S, d)`` → gates ``(B, S, k)`` and expert indices ``(B, S, k)``.
    Which of a token's k indices comes first does not change any
    position in an expert (a token's k experts differ)."""
    m = cfg.moe
    logits = x.to(m.router_dtype) @ params["router"].to(m.router_dtype)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return gate, idx


def _positions_in_expert(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """``idx (B, S, k)`` → the position of each assignment within its
    expert, counted in (s, k) order per group: an exclusive cumsum."""
    B, S, k = idx.shape
    flat = idx.reshape(B, S * k)
    onehot = _one_hot(flat, n_experts, torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    return torch.gather(pos, 2, flat[..., None]).reshape(B, S, k)


def _experts_apply(params: Params, expert_in: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """``expert_in (E, B, C, d)`` → ``(E, B, C, d)`` through each expert's
    SwiGLU: one batched matmul over the experts per weight."""
    E, B, C, d = expert_in.shape
    gw = cfg.gather_weights
    wi = gathered(params["wi"], "expert", None, None, gather=gw)
    wg = gathered(params["wg"], "expert", None, None, gather=gw)
    wo = gathered(params["wo"], "expert", None, None, gather=gw)
    xe = expert_in.reshape(E, B * C, d)
    h = torch.bmm(xe, wi.to(cfg.dtype))
    g = torch.bmm(xe, wg.to(cfg.dtype))
    h = _constrain_as(F.silu(g) * h, (E, B, C, -1),
                      "expert", "batch", None, None)
    out = torch.bmm(h, wo.to(cfg.dtype))
    return out.view(E, B, C, d)


def _dispatch(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Any]:
    """Route ``x (B, S, d)`` and fill the buffer: the experts' inputs
    ``(E, B, C, d)`` and what ``_combine`` needs to bring their outputs
    back (the einsum mode's combine weights ``(B, S, E·C)``, the scatter
    mode's buffer slots and gates)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    gate, idx = _route(params, x, cfg)
    C = expert_capacity(cfg, S)
    pos = _positions_in_expert(idx, E)                   # (B, S, k)
    keep = pos < C
    gate = (gate * keep).to(cfg.dtype)
    if m.dispatch == "einsum":
        # per token: its (E, k) expert one-hot times its (k, C) slot
        # one-hot (zero rows past the capacity) → dispatch (E, C); combine
        # carries the gates
        oe = _one_hot(idx, E, cfg.dtype).reshape(B * S, k, E) \
            .transpose(1, 2)
        oc = _one_hot(pos, C, cfg.dtype).reshape(B * S, k, C)
        dispatch = _constrain_as(torch.bmm(oe, oc).view(B, S, E * C),
                                 (B, S, E, C), "batch", None, "expert", None)
        combine = _constrain_as(
            torch.bmm(oe * gate.reshape(B * S, 1, k), oc).view(B, S, E * C),
            (B, S, E, C), "batch", None, "expert", None)
        expert_in = torch.bmm(dispatch.transpose(1, 2), x)   # (B, E·C, d)
        return constrain(expert_in.view(B, E, C, d).transpose(0, 1),
                         "expert", "batch", None, None), combine
    if m.dispatch == "scatter":
        # the same buffer by indexing; dropped assignments go to a trash
        # row past the buffer
        slot = torch.where(keep, idx * C + pos,
                           torch.full_like(idx, E * C))
        flat_slot = slot.reshape(B, S * k, 1).expand(B, S * k, d)
        buf = x.new_zeros((B, E * C + 1, d))
        buf.scatter_(1, flat_slot, x.repeat_interleave(k, dim=1))
        return constrain(buf[:, :-1].reshape(B, E, C, d).transpose(0, 1),
                         "expert", "batch", None, None), (flat_slot, gate)
    raise ValueError(f"unknown MoE dispatch {m.dispatch!r}")


def _combine(out: torch.Tensor, how: Any, cfg: ModelConfig) -> torch.Tensor:
    """The experts' outputs ``(E, B, C, d)`` back to ``(B, S, d)``, each
    token's kept assignments weighted by their gates."""
    E, B, C, d = out.shape
    flat = out.transpose(0, 1).reshape(B, E * C, d)
    if cfg.moe.dispatch == "einsum":
        return torch.bmm(how, flat)
    flat_slot, gate = how
    S, k = gate.shape[1:]
    picked = torch.gather(torch.cat([flat, flat.new_zeros((B, 1, d))], 1),
                          1, flat_slot)                      # (B, S·k, d)
    return (gate.view(B, S, 1, k) @ picked.view(B, S, k, d))[:, :, 0]


# ------------------------------------------------------------- dropless
def grouped_mm(a: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """``a (M, K)`` rows sorted by group, ``w (E, K, N)``, ``ends (E,)``
    int32 each group's end row → ``(M, N)``: rows ``ends[e-1]..ends[e]``
    times ``w[e]``. On the card, ``torch._grouped_mm`` on the device
    offsets (nothing read back), in bf16 only: another dtype raises rather
    than fall back to a loop that reads ``ends`` back. On the CPU, a loop
    over the groups."""
    if a.is_cuda:
        if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
            raise TypeError(f"grouped_mm on the card takes bf16, not "
                            f"{a.dtype} x {w.dtype}")
        return torch._grouped_mm(a, w, offs=ends)
    out = a.new_empty((a.shape[0], w.shape[-1]))
    start = 0
    for e, end in enumerate(ends.tolist()):
        out[start:end] = a[start:end] @ w[e]
        start = end
    return out


def _dropless(params: Params, x: torch.Tensor, cfg: ModelConfig,
              counts: Optional[torch.Tensor]) -> torch.Tensor:
    """Every assignment of ``x (B, S, d)``'s tokens through its expert,
    summed by the gates: ``(B, S, d)``, without the shared expert; the
    call, its rows and the experts hit added to ``counts`` where given."""
    m = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, m.top_k, m.n_experts
    xf = x.reshape(T, d)
    logits = xf.to(m.router_dtype) @ params["router"].to(m.router_dtype)
    top, idx = torch.topk(logits, k, dim=-1)                  # (T, k)
    gate = torch.softmax(top, dim=-1)
    experts, order = torch.sort(idx.reshape(-1), stable=True)
    ends = torch.searchsorted(
        experts, torch.arange(E, device=x.device, dtype=experts.dtype),
        right=True).to(torch.int32)
    if counts is not None:
        # the call, its rows, and the experts hit: 1 + where the sorted
        # ids change (five small launches, no readback)
        counts[0::2] += 1
        counts[1] += T * k
        counts[2] += (experts[1:] != experts[:-1]).sum()
    dt = cfg.dtype
    rows = xf[order // k]                                      # (T·k, d)
    h = grouped_mm(rows, params["wi"].to(dt), ends)
    g = grouped_mm(rows, params["wg"].to(dt), ends)
    out = grouped_mm(F.silu(g) * h, params["wo"].to(dt), ends)
    # back to (t, k) order by a gather of rows (a scatter of whole rows
    # writes slower): where each assignment went in the sort
    where = torch.empty_like(order)
    where[order] = torch.arange(T * k, device=x.device)
    return torch.bmm(gate.to(dt).view(T, 1, k),
                     out[where].view(T, k, d)).view(B, S, d)


def moe_block(params: Params, x: torch.Tensor, cfg: ModelConfig,
              counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (B, S, d)`` → ``(B, S, d)``; each of the B rows is one routing
    group of S tokens: dispatch, the experts, combine, plus the shared
    expert where there is one. Dropless, all B·S tokens route as one, and
    ``counts`` (if given) counts the call."""
    if cfg.moe.dispatch == "dropless":
        y = _dropless(params, x, cfg, counts)
    else:
        expert_in, how = _dispatch(params, x, cfg)
        y = _combine(_experts_apply(params, expert_in, cfg), how, cfg)
    y = constrain(y, "batch", None, None)
    if cfg.moe.shared_d_ff:
        y = y + mlp(params["shared"], x, cfg.gather_weights)
    return y

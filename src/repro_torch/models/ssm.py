"""Mamba-2 (SSD) block: projections, causal depthwise conv, SSD scan, gated
RMSNorm, plus the single-token decode recurrence.

Counterpart of ``repro/models/ssm.py`` with the reference's parameter
layouts (``wz``/``wx`` ``(d, inner)``, ``conv_x`` ``(W, inner)``, ...). A
config with ``conv_bias`` (granite-4.0-h; the reference has none) adds a
bias a conv channel, ``conv_bias_x`` ``(inner,)``, ``conv_bias_B`` and
``conv_bias_C`` ``(G·N,)``, to the conv's output in prefill and in the
decode step; without it nothing changes.
The full-sequence block runs the SSD kernel (``kernels.ssd_scan``) on both
of its branches: the kernel returns the final state on request, so serving
prefill needs no plain version. The decode step is plain PyTorch, as the
reference's is jnp.

Unlike the reference, the SSD scan keeps its configured chunk for every
length and pads the last chunk (the reference searches for a chunk that
divides T, down to 1 for a prime T); the two differ by rounding only. A
prompt shorter than ``conv_width - 1`` leaves a zero-padded conv state,
the padding the causal conv itself sees.

``ssm_specs`` and ``ssm_state_specs`` are the logical-axis trees of the
weights and the decode state; the x-stream channels shard over the model
axis, the small B/C streams stay replicated (``repro_torch.sharding``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import gathered
from repro_torch.sharding import constrain, is_dtensor
from repro_torch.util import resolve_device

Params = Dict[str, Any]


def init_ssm(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             device: Any) -> Params:
    """Layer-stacked SSM weights ``(n_layers, ...)``: the reference's
    leaves, dtypes and scales (dense weights normal * fan_in^-1/2, conv
    weights normal * 0.1; ``A_log``, ``D``, ``dt_bias`` and
    ``norm_scale`` fp32), drawn from ``gen``; with ``cfg.conv_bias`` the
    conv biases (normal * 0.1) are drawn after them."""
    s = cfg.ssm
    L, d, di = n_layers, cfg.d_model, cfg.ssm_inner
    H, N, G, W = cfg.ssm_heads, s.state_dim, s.n_groups, s.conv_width
    pd = cfg.param_dtype

    def normal(shape, scale):
        return (torch.randn((L,) + shape, generator=gen, device=device)
                * scale).to(pd)

    def dense(shape):
        return normal(shape, shape[0] ** -0.5)

    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((L, H), generator=gen, **f32)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))        # inverse softplus
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    p = {
        "wz": dense((d, di)), "wx": dense((d, di)),
        "wB": dense((d, G * N)), "wC": dense((d, G * N)),
        "wdt": dense((d, H)),
        "conv_x": normal((W, di), 0.1),
        "conv_B": normal((W, G * N), 0.1),
        "conv_C": normal((W, G * N), 0.1),
        "A_log": a_log.expand(L, H).clone(),
        "D": torch.ones((L, H), **f32),
        "dt_bias": dt_bias,
        "norm_scale": torch.ones((L, di), **f32),
        "wo": dense((di, d)),
    }
    if cfg.conv_bias:
        p.update(conv_bias_x=normal((di,), 0.1),
                 conv_bias_B=normal((G * N,), 0.1),
                 conv_bias_C=normal((G * N,), 0.1))
    return p


def ssm_specs(conv_bias: bool = False) -> Dict[str, Any]:
    p = {
        "wz": ("fsdp", "tp"), "wx": ("fsdp", "tp"),
        "wB": ("fsdp", None), "wC": ("fsdp", None), "wdt": ("fsdp", "tp"),
        "conv_x": (None, "tp"), "conv_B": (None, None), "conv_C": (None, None),
        "A_log": ("tp",), "D": ("tp",), "dt_bias": ("tp",),
        "norm_scale": ("tp",), "wo": ("tp", "fsdp"),
    }
    if conv_bias:
        p.update(conv_bias_x=("tp",), conv_bias_B=(None,),
                 conv_bias_C=(None,))
    return p


def ssm_state_specs(layer_stacked: bool) -> Dict[str, Any]:
    lead = (None,) if layer_stacked else ()
    return {
        "ssm": lead + ("batch", "tp", None, None),
        "conv_x": lead + ("batch", None, "tp"),
        "conv_B": lead + ("batch", None, None),
        "conv_C": lead + ("batch", None, None),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor
                           ) -> torch.Tensor:
    """x: (B, T, C); w: (W, C) — causal depthwise conv along T. A sharded
    x (a DTensor: rows and channels split over ranks, T whole) runs on
    each rank's shard, with w placed on x's channels: the same sum as W
    shifted products, accumulated in fp32. (DTensor's own rule for the
    padding is missing or broken in some torch releases.)"""
    W, C = w.shape
    if is_dtensor(x):
        return _sharded_conv(x, w)
    xp = F.pad(x.transpose(1, 2), (W - 1, 0))          # (B, C, W-1+T)
    out = F.conv1d(xp, w.t()[:, None, :], groups=C)    # (B, C, T)
    return out.transpose(1, 2)


def _sharded_conv(x, w):
    """The conv of DTensor ``x`` on each rank's shard. The conv is linear,
    so a partial sum in ``x`` stays one in the output (its gradient is
    whole), and ``w``'s gradient is a partial sum over every mesh dim
    that splits ``x``'s rows or sums it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.kernels import _shards
    mesh = x.device_mesh
    for p in x.placements:
        if p.is_shard() and p.dim not in (0, 2):
            raise ValueError(f"causal_conv: x placed {tuple(x.placements)}"
                             ": the sequence may not be sharded")
    # w on x's channel split, replicated elsewhere
    place = tuple(Shard(1) if p.is_shard(2) else Replicate()
                  for p in x.placements)
    if not is_dtensor(w):
        w = DTensor.from_local(w, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    if tuple(w.placements) != place:
        w = w.redistribute(mesh, place)
    xl = x.to_local(grad_placements=tuple(
        Replicate() if p.is_partial() else p for p in x.placements))
    wl = w.to_local(grad_placements=tuple(
        Partial() if q.is_replicate() and not p.is_replicate() else q
        for p, q in zip(x.placements, place)))
    W, T = wl.shape[0], xl.shape[1]
    xp = F.pad(xl, (0, 0, W - 1, 0)).float()
    wf = wl.float()
    out = xp[:, 0:T] * wf[0]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * wf[i]
    return _shards.wrap(out.to(xl.dtype), x, x.shape)


def _conv_branch(params: Params, branch: str, raw: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The causal conv of one input branch (``x``, ``B`` or ``C``) over the
    whole sequence, with its bias where the config has one."""
    dtype = cfg.dtype
    out = _causal_depthwise_conv(raw, params["conv_" + branch].to(dtype))
    if cfg.conv_bias:
        out = out + params["conv_bias_" + branch].to(dtype)
    return out


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _conv_tail(raw: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width - 1`` raw inputs (B, W-1, C), zero-padded on the
    left when the sequence is shorter."""
    T = raw.shape[1]
    if T >= width - 1:
        return raw[:, T - (width - 1):, :]
    return F.pad(raw, (0, 0, width - 1 - T, 0))


def ssm_block(params: Params, x: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False):
    """Full-sequence SSD forward (``lm_forward``; prefill with
    ``return_state``, which adds the decode state dict)."""
    s = cfg.ssm
    B, T, _ = x.shape
    H, P, N, G = cfg.ssm_heads, s.head_dim, s.state_dim, s.n_groups
    dtype = cfg.dtype
    gw = cfg.gather_weights
    z = x @ gathered(params["wz"], None, "tp", gather=gw).to(dtype)
    xs_raw = x @ gathered(params["wx"], None, "tp", gather=gw).to(dtype)
    Bs_raw = x @ gathered(params["wB"], None, None, gather=gw).to(dtype)
    Cs_raw = x @ gathered(params["wC"], None, None, gather=gw).to(dtype)
    dt = x @ gathered(params["wdt"], None, "tp", gather=gw).to(dtype)
    xs = F.silu(_conv_branch(params, "x", xs_raw, cfg))
    Bs = F.silu(_conv_branch(params, "B", Bs_raw, cfg))
    Cs = F.silu(_conv_branch(params, "C", Cs_raw, cfg))
    xs = constrain(xs, "batch", None, "tp")
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    # under a mesh the scan's other operands are placed as x is: rows by
    # batch, heads by tp, the shared B/C groups whole
    dt = constrain(dt, "batch", None, "tp")
    Bs = constrain(Bs, "batch", None, None)
    Cs = constrain(Cs, "batch", None, None)
    out = ssd_kernel.ssd_scan(
        xs.reshape(B, T, H, P).contiguous(), dt.contiguous(), A,
        Bs.reshape(B, T, G, N).contiguous(),
        Cs.reshape(B, T, G, N).contiguous(), params["D"],
        chunk=s.chunk_size, return_state=return_state)
    y, final = out if return_state else (out, None)
    y = _gated_rmsnorm(y.reshape(B, T, -1), z, params["norm_scale"],
                       cfg.norm_eps)
    y = constrain(y, "batch", None, "tp")
    out = y @ gathered(params["wo"], "tp", None, gather=gw).to(dtype)
    if not return_state:
        return out
    W = s.conv_width
    state = {"ssm": final,
             "conv_x": _conv_tail(xs_raw, W),
             "conv_B": _conv_tail(Bs_raw, W),
             "conv_C": _conv_tail(Cs_raw, W)}
    return out, state


# --------------------------------------------------------------- decode path
def init_ssm_state(cfg: ModelConfig, batch: int,
                   n_layers: Optional[int] = None,
                   device: Any = "cuda") -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    s = cfg.ssm
    H, P, N, G, W = cfg.ssm_heads, s.head_dim, s.state_dim, s.n_groups, \
        s.conv_width
    di = cfg.ssm_inner
    lead = (n_layers,) if n_layers else ()

    def zeros(*dims, dtype=cfg.dtype):
        return torch.zeros(lead + dims, dtype=dtype, device=device)

    return {"ssm": zeros(batch, H, P, N, dtype=torch.float32),
            "conv_x": zeros(batch, W - 1, di),
            "conv_B": zeros(batch, W - 1, G * N),
            "conv_C": zeros(batch, W - 1, G * N)}


def _conv_step(state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """state (B, W-1, C), xt (B, C) → conv output (B, C), plus ``bias``
    (C,) where given; the state is shifted by one row in place."""
    full = torch.cat([state, xt[:, None, :]], dim=1)     # (B, W, C)
    state.copy_(full[:, 1:, :])
    out = (full * w).sum(dim=1)
    return out if bias is None else out + bias


def ssm_decode_step(params: Params, x: torch.Tensor, cfg: ModelConfig,
                    state: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) → (B, 1, d); the constant-size state is updated in
    place and returned."""
    s = cfg.ssm
    B = x.shape[0]
    H, P, N, G = cfg.ssm_heads, s.head_dim, s.state_dim, s.n_groups
    dtype = cfg.dtype
    xt = x[:, 0, :]
    z = xt @ params["wz"].to(dtype)

    def conv(branch):
        bias = params["conv_bias_" + branch].to(dtype) if cfg.conv_bias \
            else None
        return _conv_step(state["conv_" + branch],
                          xt @ params["w" + branch].to(dtype),
                          params["conv_" + branch].to(dtype), bias)
    xs, Bs, Cs = conv("x"), conv("B"), conv("C")
    dt = xt @ params["wdt"].to(dtype)
    xs, Bs, Cs = F.silu(xs), F.silu(Bs), F.silu(Cs)
    dt = F.softplus(dt.float() + params["dt_bias"])      # (B, H)
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(B, H, P).float()
    # each group's row repeated over its H / G heads
    Bh = Bs.reshape(B, G, 1, N).expand(B, G, H // G, N).reshape(B, H, N) \
        .float()
    Ch = Cs.reshape(B, G, 1, N).expand(B, G, H // G, N).reshape(B, H, N) \
        .float()
    decay = torch.exp(dt * A)                            # (B, H)
    ssm = state["ssm"]
    ssm.mul_(decay[..., None, None]).add_(
        (dt[..., None] * xh)[..., None] * Bh[:, :, None, :])
    y = (ssm @ Ch[..., None])[..., 0] + xh * params["D"][None, :, None]
    y = _gated_rmsnorm(y.reshape(B, -1).to(dtype), z, params["norm_scale"],
                       cfg.norm_eps)
    return (y @ params["wo"].to(dtype))[:, None, :], state

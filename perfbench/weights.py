"""The benchmark's weights: made from the run's seed, on the device, in
the type they are served or trained in, and handed to the program and to
the plain reference alike.

The tree has the program's parameter layout (``repro_torch.models.lm``:
per-layer leaves stacked on a leading layer axis; a hybrid's shared block
under ``"shared"`` with one output projector per site), which is the
interface both sides read. Each stacked leaf is one draw from a
``torch.Generator`` on the device, in fp32 blocks of at most 2**28
elements, scaled and cast to the weights' type. Scales follow the
Mamba-2 and Zamba2 conventions the program's own init uses: dense weights
normal * fan_in^-1/2, conv weights normal * 0.1, the embedding at 0.02,
``A_log = log(1..16)``, ``D = 1``, ``dt_bias`` the inverse softplus of a
log-uniform draw in [dt_min, dt_max]; norm scales 1. ``A_log``, ``D``,
``dt_bias`` and every norm scale are fp32, as in the program.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

_BLOCK = 1 << 28


def _normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
            dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), _BLOCK):
        n = min(_BLOCK, flat.numel() - s)
        flat[s:s + n] = torch.randn(n, generator=gen, device=device) * scale
    return out


def _ones(shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


def make_params(cfg: Any, seed: int, device: Any) -> Dict[str, Any]:
    """Weights of an SSM or hybrid ``cfg`` (a ``repro_torch`` config) in
    ``cfg.param_dtype``, drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    pd = cfg.param_dtype
    s = cfg.ssm
    L, d, di, H = cfg.n_layers, cfg.d_model, cfg.ssm_inner, cfg.ssm_heads
    N, G, W = s.state_dim, s.n_groups, s.conv_width

    def dense(shape, lead=(L,)):
        return _normal(gen, lead + shape, shape[0] ** -0.5, pd, dev)

    u = torch.rand((L, H), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    ssm = {
        "wz": dense((d, di)), "wx": dense((d, di)),
        "wB": dense((d, G * N)), "wC": dense((d, G * N)),
        "wdt": dense((d, H)),
        "conv_x": _normal(gen, (L, W, di), 0.1, pd, dev),
        "conv_B": _normal(gen, (L, W, G * N), 0.1, pd, dev),
        "conv_C": _normal(gen, (L, W, G * N), 0.1, pd, dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)
                           ).expand(L, H).contiguous(),
        "D": _ones((L, H), dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm_scale": _ones((L, di), dev),
        "wo": dense((di, d)),
    }
    params: Dict[str, Any] = {
        "embed": {"tokens": _normal(gen, (cfg.padded_vocab, d), 0.02, pd,
                                    dev)},
        "final_norm": {"scale": _ones((d,), dev)},
        "layers": {"norm": {"scale": _ones((L, d), dev)}, "ssm": ssm},
    }
    if not cfg.tied_embeddings:
        raise NotImplementedError("untied embeddings: no such config here")
    if cfg.family == "hybrid":
        w, nh, kv, hd = 2 * d, cfg.n_heads, cfg.n_kv_heads, \
            cfg.resolved_head_dim
        if cfg.padded_heads != nh or cfg.padded_kv_heads != kv:
            raise NotImplementedError("padded attention heads")
        params["shared"] = {
            "norm1": {"scale": _ones((w,), dev)},
            "attn": {"wq": _normal(gen, (w, nh, hd), w ** -0.5, pd, dev),
                     "wk": _normal(gen, (w, kv, hd), w ** -0.5, pd, dev),
                     "wv": _normal(gen, (w, kv, hd), w ** -0.5, pd, dev),
                     "wo": _normal(gen, (nh, hd, w), (nh * hd) ** -0.5, pd,
                                   dev)},
            "norm2": {"scale": _ones((w,), dev)},
            "mlp": {"wi": dense((w, cfg.d_ff), ()),
                    "wg": dense((w, cfg.d_ff), ()),
                    "wo": dense((cfg.d_ff, w), ())},
            "proj": _normal(gen, (cfg.hybrid_sites, w, d), w ** -0.5, pd,
                            dev),
        }
    return params

"""The ``ssm`` family: Mamba-2 (arXiv:2405.21060), a stack of Mamba-2
layers (an rmsnorm, then the mixer, on the residual), a final norm and
logits tied to the embedding; the program's ``repro_torch`` SSM family
(``mamba2_370m``).

Weights follow the Mamba-2 conventions the program's own init uses: dense
weights normal * fan_in^-1/2, conv weights normal * 0.1, the embedding at
0.02, ``A_log = log(1..16)``, ``D = 1``, ``dt_bias`` the inverse softplus
of a log-uniform draw in [dt_min, dt_max]; norm scales 1. ``A_log``,
``D``, ``dt_bias`` and every norm scale are fp32, as in the program. No
biases in the projections or the conv, as in the program.

The hybrid family (``families/hybrid.py``) builds on this one: its
weights, model and counts start from these.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch

from perfbench.counts.decode import SIZE
from perfbench.reference.model import Model as Base
from perfbench.weights import generator, normal, ones


def sizes(cfg: Any) -> Dict[str, Any]:
    s = cfg.ssm
    return {"family": cfg.family, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
            "padded_vocab": cfg.padded_vocab, "norm_eps": cfg.norm_eps,
            "ssm": {"state_dim": s.state_dim, "head_dim": s.head_dim,
                    "expand": s.expand, "conv_width": s.conv_width,
                    "n_groups": s.n_groups, "chunk_size": s.chunk_size}}


# ------------------------------------------------------------------ weights
def draw(cfg: Any, gen: torch.Generator, dev: torch.device
         ) -> Dict[str, Any]:
    """The layer stack, the embedding and the final norm, drawn from
    ``gen`` in this order."""
    if not cfg.tied_embeddings:
        raise NotImplementedError("untied embeddings: no such config here")
    pd = cfg.param_dtype
    s = cfg.ssm
    L, d, di, H = cfg.n_layers, cfg.d_model, cfg.ssm_inner, cfg.ssm_heads
    N, G, W = s.state_dim, s.n_groups, s.conv_width

    def dense(shape):
        return normal(gen, (L,) + shape, shape[0] ** -0.5, pd, dev)

    u = torch.rand((L, H), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    ssm = {
        "wz": dense((d, di)), "wx": dense((d, di)),
        "wB": dense((d, G * N)), "wC": dense((d, G * N)),
        "wdt": dense((d, H)),
        "conv_x": normal(gen, (L, W, di), 0.1, pd, dev),
        "conv_B": normal(gen, (L, W, G * N), 0.1, pd, dev),
        "conv_C": normal(gen, (L, W, G * N), 0.1, pd, dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)
                           ).expand(L, H).contiguous(),
        "D": ones((L, H), dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm_scale": ones((L, di), dev),
        "wo": dense((di, d)),
    }
    return {
        "embed": {"tokens": normal(gen, (cfg.padded_vocab, d), 0.02, pd,
                                   dev)},
        "final_norm": {"scale": ones((d,), dev)},
        "layers": {"norm": {"scale": ones((L, d), dev)}, "ssm": ssm},
    }


def make_params(cfg: Any, seed: int, device: Any) -> Dict[str, Any]:
    dev = torch.device(device)
    return draw(cfg, generator(seed, dev), dev)


# -------------------------------------------------------------------- model
class Model(Base):
    """Mamba-2 in fp32: every layer ``x + mixer(rmsnorm(x))``."""

    def hidden(self, params, tokens, layer_fn=None):
        run = layer_fn or (lambda fn, *a: fn(*a))
        x = self.embed(params, tokens)
        for i in range(self.m["n_layers"]):
            x = run(self.ssm_layer, self.layer_at(params["layers"], i), x)
        return self.rmsnorm(x, params["final_norm"]["scale"])

    def ssm_layer(self, lp, x: torch.Tensor) -> torch.Tensor:
        return x + self.ssm_block(lp["ssm"], self.rmsnorm(
            x, lp["norm"]["scale"]), self.m["ssm"])


# ------------------------------------------------------------------- counts
def _mixer(m: Mapping[str, Any]) -> Tuple[int, int, int, int, int, int]:
    """(d, di, H, N, G, W) of the Mamba-2 mixer."""
    s, d = m["ssm"], m["d_model"]
    di = s["expand"] * d
    return (d, di, di // s["head_dim"], s["state_dim"], s["n_groups"],
            s["conv_width"])


def leaves(m: Mapping[str, Any]) -> Dict[str, int]:
    """Elements of each weight group: the embedding table (``padded_vocab``
    rows as made, of which ``vocab_size`` are tokens), the layer stack and
    the final norm."""
    d, di, H, N, G, W = _mixer(m)
    per = (d * (2 * di + 2 * G * N + H) + W * (di + 2 * G * N)
           + 3 * H + di + di * d + d)
    return {"embed": m["padded_vocab"] * d, "layers": m["n_layers"] * per,
            "final_norm": d}


def flops_params(m: Mapping[str, Any]) -> int:
    """N of "2 N a token to infer, 6 N to train": every weight once."""
    return sum(leaves(m).values())


def weight_elements(m: Mapping[str, Any]) -> Tuple[int, int]:
    """(elements in the weights' type, fp32 elements) a decode step reads:
    the token rows of the (tied) table and every layer; ``A_log``, ``D``,
    ``dt_bias`` and the norm scales are the fp32 ones."""
    d, di, H = _mixer(m)[:3]
    lv = leaves(m)
    fp32 = m["n_layers"] * (3 * H + di + d) + d
    n = m["vocab_size"] * d + lv["layers"] + lv["final_norm"] - fp32
    return n, fp32


def weight_bytes(m: Mapping[str, Any], dtype: str) -> int:
    n, fp32 = weight_elements(m)
    return n * SIZE[dtype] + fp32 * 4


def state_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """One slot's SSM state (fp32) and conv state (the activations' type),
    over all layers."""
    d, di, H, N, G, W = _mixer(m)
    per = 4 * H * m["ssm"]["head_dim"] * N \
        + SIZE[dtype] * (W - 1) * (di + 2 * G * N)
    return m["n_layers"] * per


def kv_row_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """No attention: no KV cache."""
    return 0

"""The ``hybrid`` family: Zamba2 (arXiv:2411.15242), the Mamba-2 stack of
``families/ssm.py`` with one shared transformer block that runs before
layers 0, every, 2 every, ... (``hybrid_attn_every``) on concat(x, x0) at
width 2 d, each site with its own output projector 2 d -> d; the
program's ``repro_torch`` hybrid family (``zamba2_1p2b``).

The shared block: rmsnorm, causal attention with rotary positions
(``n_heads``/``n_kv_heads`` of ``head_dim``), rmsnorm, a SwiGLU MLP of
``d_ff``, each on its residual. Departures from the published model,
shared with the program under test: no biases, and the LoRA adapters of
the shared block left out. Its weights are drawn after the Mamba-2
stack's, from the same generator: attention at width^-1/2 (``wo`` at
(heads * head_dim)^-1/2), the MLP and the projectors at fan_in^-1/2.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

import torch

from perfbench import families
from perfbench.counts.decode import SIZE
from perfbench.weights import generator, normal, ones

ssm = families.module("ssm", Path(__file__).resolve().parent)


def sizes(cfg: Any) -> Dict[str, Any]:
    out = ssm.sizes(cfg)
    out.update(hybrid_attn_every=cfg.hybrid_attn_every, n_heads=cfg.n_heads,
               n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
               d_ff=cfg.d_ff, rope_theta=cfg.rope_theta)
    return out


# ------------------------------------------------------------------ weights
def make_params(cfg: Any, seed: int, device: Any) -> Dict[str, Any]:
    dev = torch.device(device)
    gen = generator(seed, dev)
    pd = cfg.param_dtype
    w, nh, kv, hd = 2 * cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    if cfg.padded_heads != nh or cfg.padded_kv_heads != kv:
        raise NotImplementedError("padded attention heads")
    params = ssm.draw(cfg, gen, dev)

    def dense(shape):
        return normal(gen, shape, shape[0] ** -0.5, pd, dev)

    params["shared"] = {
        "norm1": {"scale": ones((w,), dev)},
        "attn": {"wq": normal(gen, (w, nh, hd), w ** -0.5, pd, dev),
                 "wk": normal(gen, (w, kv, hd), w ** -0.5, pd, dev),
                 "wv": normal(gen, (w, kv, hd), w ** -0.5, pd, dev),
                 "wo": normal(gen, (nh, hd, w), (nh * hd) ** -0.5, pd,
                              dev)},
        "norm2": {"scale": ones((w,), dev)},
        "mlp": {"wi": dense((w, cfg.d_ff)), "wg": dense((w, cfg.d_ff)),
                "wo": dense((cfg.d_ff, w))},
        "proj": normal(gen, (cfg.hybrid_sites, w, cfg.d_model), w ** -0.5,
                       pd, dev),
    }
    return params


# -------------------------------------------------------------------- model
class Model(ssm.Model):
    """Zamba2 in fp32: the shared block at each site, then the site's
    Mamba-2 layer."""

    def hidden(self, params, tokens, layer_fn=None):
        run = layer_fn or (lambda fn, *a: fn(*a))
        x = self.embed(params, tokens)
        x0 = x
        every = self.m["hybrid_attn_every"]
        site = 0
        for i in range(self.m["n_layers"]):
            if i % every == 0:
                x = run(self.shared, params["shared"], x, x0, site)
                site += 1
            x = run(self.ssm_layer, self.layer_at(params["layers"], i), x)
        return self.rmsnorm(x, params["final_norm"]["scale"])

    def shared(self, sh, x: torch.Tensor, x0: torch.Tensor,
               site: int) -> torch.Tensor:
        w_in = torch.cat([x, x0], dim=-1)
        w_mid = w_in + self.attention(
            sh["attn"], self.rmsnorm(w_in, sh["norm1"]["scale"]))
        w_out = w_mid + self.mlp(sh["mlp"], self.rmsnorm(
            w_mid, sh["norm2"]["scale"]))
        return x + self.mm(w_out, sh["proj"][site])


# ------------------------------------------------------------------- counts
def sites(m: Mapping[str, Any]) -> int:
    """Shared-block sites: before layers 0, every, 2 every, ..."""
    return -(-m["n_layers"] // m["hybrid_attn_every"])


def leaves(m: Mapping[str, Any]) -> Dict[str, int]:
    """The Mamba-2 stack's groups, and the shared block without and with
    its per-site projectors."""
    out = ssm.leaves(m)
    d = m["d_model"]
    w, hd, ff = 2 * d, m["head_dim"], m["d_ff"]
    nh, kv = m["n_heads"], m["n_kv_heads"]
    out["shared"] = (2 * w + w * hd * (2 * nh + 2 * kv) + 3 * w * ff)
    out["proj"] = sites(m) * w * d
    return out


def flops_params(m: Mapping[str, Any]) -> int:
    """Every weight a token passes through: the shared block once a site
    (``family_model_flops`` of ``chip_smoke.py``)."""
    lv = leaves(m)
    return sum(lv.values()) + (sites(m) - 1) * lv["shared"]


def weight_elements(m: Mapping[str, Any]) -> Tuple[int, int]:
    """The Mamba-2 stack's, and the shared block with its projectors (its
    two norm scales fp32)."""
    n, fp32 = ssm.weight_elements(m)
    lv = leaves(m)
    w = 2 * m["d_model"]
    return n + lv["shared"] + lv["proj"] - 2 * w, fp32 + 2 * w


def weight_bytes(m: Mapping[str, Any], dtype: str) -> int:
    n, fp32 = weight_elements(m)
    return n * SIZE[dtype] + fp32 * 4


state_bytes = ssm.state_bytes


def kv_row_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """One position's K and V over every shared-block site."""
    return sites(m) * 2 * m["n_kv_heads"] * m["head_dim"] * SIZE[dtype]

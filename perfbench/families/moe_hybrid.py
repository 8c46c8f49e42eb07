"""The ``moe_hybrid`` family: granite-4.0-h (model_type
``granitemoehybrid``), the program's ``repro_torch`` moe_hybrid family
(``granite_4_0_h_small``).

Every layer is an rmsnorm, its mixer, the residual scaled by
``residual_multiplier``, an rmsnorm, an MoE block with a shared expert,
the residual scaled again. The mixer is, as ``layer_types`` says, a
Mamba-2 block whose causal conv carries a bias a channel (no projection
bias), or causal GQA attention with no positional embedding (NoPE) and a
softmax scale of ``attention_multiplier``. The MoE block's router
(``moe.n_experts`` outputs) takes each token's ``top_k`` largest logits,
its gates their softmax; each of those experts (SwiGLU of ``moe.d_ff``)
runs on the token and the outputs are summed by the gates, none dropped;
the shared SwiGLU expert of ``moe.shared_d_ff`` is added. The embedding
is multiplied by ``embedding_multiplier``, the tied logits divided by
``logits_scaling``.

Weights in the program's layout: ``layers`` stacks each layer's two norms
and its MoE (``router`` fp32 ``(d, E)``, ``wi``/``wg`` ``(E, d, ff)``,
``wo`` ``(E, ff, d)``, ``shared``); ``ssm`` stacks the Mamba-2 mixers and
``attn`` the attention mixers, each in layer order. Drawn from one
generator in this order: the embedding (0.02 / ``embedding_multiplier``,
so that the scaled rows enter the residual at 0.02, as the other
configurations' do: at 0.02 itself a row times 12 outweighs every layer's
output, the tied logits then favour the input token by some fifteen
standard deviations, and greedy decoding repeats a prompt's last token
for ever, which no output check can read), the Mamba-2 mixers (at
``families/ssm.py``'s scales, then the conv biases at 0.1), the
attention mixers (width^-1/2, ``wo`` at (heads * head_dim)^-1/2), then
layer by group the norms (1), the router, the experts and the shared
expert (fan_in^-1/2); ``A_log``, ``D``, ``dt_bias``, norm scales and the
router are fp32.

The plain model is fp32 PyTorch: the shared pieces of
``reference/model.py`` (rmsnorm, conv, SSD, ``mm``), and its own Mamba-2
mixer with the conv bias, NoPE attention and MoE (a loop over the experts
of every token's top-k). It imports nothing of the program.

The decode step's byte terms count every expert's weights once a step.
At 32 live slots a step routes 320 assignments, which leave 72 (62/72)^32
= 0.60 of a layer's 72 experts idle on average, so the count is 0.45 GB
above what a step reads: 0.70% of the weights' bytes, 0.60% of a step's
at 32 slots of 2,048 positions.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from perfbench.counts.decode import SIZE
from perfbench.reference.model import Model as Base
from perfbench.weights import generator, normal, ones


def sizes(cfg: Any) -> Dict[str, Any]:
    s, m = cfg.ssm, cfg.moe
    return {"family": cfg.family, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
            "padded_vocab": cfg.padded_vocab, "norm_eps": cfg.norm_eps,
            "layer_types": list(cfg.layer_types),
            "ssm": {"state_dim": s.state_dim, "head_dim": s.head_dim,
                    "expand": s.expand, "conv_width": s.conv_width,
                    "n_groups": s.n_groups, "chunk_size": s.chunk_size,
                    "conv_bias": cfg.conv_bias},
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "nope": cfg.rope_theta <= 0,
            "moe": {"n_experts": m.n_experts, "top_k": m.top_k,
                    "d_ff": m.d_ff, "shared_d_ff": m.shared_d_ff,
                    "dispatch": m.dispatch},
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "attention_multiplier": cfg.attention_multiplier,
            "logits_scaling": cfg.logits_scaling}


def _count(m: Mapping[str, Any], kind: str) -> int:
    return sum(1 for k in m["layer_types"] if k == kind)


# ------------------------------------------------------------------ weights
def make_params(cfg: Any, seed: int, device: Any) -> Dict[str, Any]:
    if not cfg.tied_embeddings:
        raise NotImplementedError("untied embeddings: no such config here")
    if cfg.padded_heads != cfg.n_heads or \
            cfg.padded_kv_heads != cfg.n_kv_heads:
        raise NotImplementedError("padded attention heads")
    dev = torch.device(device)
    gen = generator(seed, dev)
    pd = cfg.param_dtype
    s, mo = cfg.ssm, cfg.moe
    L, d = cfg.n_layers, cfg.d_model
    di, H = cfg.ssm_inner, cfg.ssm_heads
    N, G, W = s.state_dim, s.n_groups, s.conv_width
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    E, ff, fs = mo.n_experts, mo.d_ff, mo.shared_d_ff
    n_ssm, n_attn = cfg.n_mixers("mamba"), cfg.n_mixers("attention")

    def stack(n, shape, scale, dtype=pd):
        return normal(gen, (n,) + shape, scale, dtype, dev)

    params = {"embed": {"tokens": normal(
                  gen, (cfg.padded_vocab, d),
                  0.02 / cfg.embedding_multiplier, pd, dev)},
              "final_norm": {"scale": ones((d,), dev)}}

    u = torch.rand((n_ssm, H), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    ssm = {
        "wz": stack(n_ssm, (d, di), d ** -0.5),
        "wx": stack(n_ssm, (d, di), d ** -0.5),
        "wB": stack(n_ssm, (d, G * N), d ** -0.5),
        "wC": stack(n_ssm, (d, G * N), d ** -0.5),
        "wdt": stack(n_ssm, (d, H), d ** -0.5),
        "conv_x": stack(n_ssm, (W, di), 0.1),
        "conv_B": stack(n_ssm, (W, G * N), 0.1),
        "conv_C": stack(n_ssm, (W, G * N), 0.1),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)
                           ).expand(n_ssm, H).contiguous(),
        "D": ones((n_ssm, H), dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm_scale": ones((n_ssm, di), dev),
        "wo": stack(n_ssm, (di, d), di ** -0.5),
    }
    if cfg.conv_bias:
        ssm.update(conv_bias_x=stack(n_ssm, (di,), 0.1),
                   conv_bias_B=stack(n_ssm, (G * N,), 0.1),
                   conv_bias_C=stack(n_ssm, (G * N,), 0.1))
    params["ssm"] = ssm
    params["attn"] = {"wq": stack(n_attn, (d, nh, hd), d ** -0.5),
                      "wk": stack(n_attn, (d, kv, hd), d ** -0.5),
                      "wv": stack(n_attn, (d, kv, hd), d ** -0.5),
                      "wo": stack(n_attn, (nh, hd, d), (nh * hd) ** -0.5)}
    moe = {"router": stack(L, (d, E), d ** -0.5, torch.float32),
           "wi": stack(L, (E, d, ff), d ** -0.5),
           "wg": stack(L, (E, d, ff), d ** -0.5),
           "wo": stack(L, (E, ff, d), ff ** -0.5)}
    if fs:
        moe["shared"] = {"wi": stack(L, (d, fs), d ** -0.5),
                         "wg": stack(L, (d, fs), d ** -0.5),
                         "wo": stack(L, (fs, d), fs ** -0.5)}
    params["layers"] = {"norm1": {"scale": ones((L, d), dev)},
                        "norm2": {"scale": ones((L, d), dev)},
                        "moe": moe}
    return params


# -------------------------------------------------------------------- model
class Model(Base):
    """granite-4.0-h in fp32, layer by layer as ``layer_types`` says."""

    def hidden(self, params, tokens, layer_fn=None):
        run = layer_fn or (lambda fn, *a: fn(*a))
        x = self.embed(params, tokens) * self.m["embedding_multiplier"]
        seen = {"mamba": 0, "attention": 0}
        for i, kind in enumerate(self.m["layer_types"]):
            stack = params["ssm" if kind == "mamba" else "attn"]
            mixer = self.layer_at(stack, seen[kind])
            seen[kind] += 1
            x = run(self.layer, self.layer_at(params["layers"], i), mixer,
                    kind, x)
        return self.rmsnorm(x, params["final_norm"]["scale"])

    def layer(self, lp, mp, kind: str, x: torch.Tensor) -> torch.Tensor:
        r = self.m["residual_multiplier"]
        h = self.rmsnorm(x, lp["norm1"]["scale"])
        a = self.mamba(mp, h) if kind == "mamba" else self.nope_attention(
            mp, h)
        x = x + r * a
        h = self.rmsnorm(x, lp["norm2"]["scale"])
        y = self.experts(lp["moe"], h)
        if "shared" in lp["moe"]:
            y = y + self.mlp(lp["moe"]["shared"], h)
        return x + r * y

    def logits(self, params, h):
        return super().logits(params, h) / self.m["logits_scaling"]

    def mamba(self, p, h: torch.Tensor) -> torch.Tensor:
        """The Mamba-2 mixer: projections, the causal conv with its bias
        where the sizes say so, the SSD, the gated norm, the output
        projection."""
        s = self.m["ssm"]
        Bsz, T, d = h.shape
        di = s["expand"] * d
        P, N, G = s["head_dim"], s["state_dim"], s["n_groups"]
        H = di // P

        def branch(name):
            out = self.conv(self.mm(h, p["w" + name]), p["conv_" + name])
            if s["conv_bias"]:
                out = out + p["conv_bias_" + name].float()
            return F.silu(out)
        z = self.mm(h, p["wz"])
        xs, Bs, Cs = branch("x"), branch("B"), branch("C")
        dt = F.softplus(self.mm(h, p["wdt"]) + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())

        def heads(t):   # (B, T, G*N) -> (B, T, H, N), a group per H/G heads
            return t.reshape(Bsz, T, G, 1, N).expand(
                Bsz, T, G, H // G, N).reshape(Bsz, T, H, N)
        y = self.ssd(xs.reshape(Bsz, T, H, P), dt, A, heads(Bs), heads(Cs),
                     p["D"], s["chunk_size"])
        y = y.reshape(Bsz, T, di) * F.silu(z)
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True)
                            + self.m["norm_eps"]) * p["norm_scale"].float()
        return self.mm(y, p["wo"])

    def nope_attention(self, p, h: torch.Tensor) -> torch.Tensor:
        """Causal GQA attention without positions, scores scaled by
        ``attention_multiplier``."""
        Bsz, T, w = h.shape
        hd = self.m["head_dim"]
        nh, kv = self.m["n_heads"], self.m["n_kv_heads"]
        q = self.mm(h, p["wq"].reshape(w, -1)).view(Bsz, T, nh, hd)
        k = self.mm(h, p["wk"].reshape(w, -1)).view(Bsz, T, kv, hd)
        v = self.mm(h, p["wv"].reshape(w, -1)).view(Bsz, T, kv, hd)
        k = k.repeat_interleave(nh // kv, dim=2)
        v = v.repeat_interleave(nh // kv, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # B, H, T, hd
        causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
        outs = []
        for s in range(0, T, 1024):    # query blocks bound the scores
            sc = (q[:, :, s:s + 1024] @ k.transpose(-1, -2)) \
                * self.m["attention_multiplier"]
            sc = sc.masked_fill(~causal[s:s + 1024], float("-inf"))
            outs.append(torch.softmax(sc, dim=-1) @ v)
        o = torch.cat(outs, dim=2).transpose(1, 2).reshape(Bsz, T, nh * hd)
        return self.mm(o, p["wo"].reshape(nh * hd, w))

    def experts(self, p, h: torch.Tensor) -> torch.Tensor:
        """The routed experts: each token's ``top_k`` largest router
        logits, gates their softmax; expert by expert, the tokens that
        chose it through its SwiGLU, added at their gates."""
        mo = self.m["moe"]
        Bsz, T, d = h.shape
        x = h.reshape(Bsz * T, d)
        top, idx = torch.topk(self.mm(x, p["router"]), mo["top_k"], dim=-1)
        gate = torch.softmax(top, dim=-1)
        out = torch.zeros_like(x)
        for e in range(mo["n_experts"]):
            chose = idx == e                                    # (BT, k)
            rows = chose.any(dim=-1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            xe = x[rows]
            ye = self.mm(F.silu(self.mm(xe, p["wg"][e]))
                         * self.mm(xe, p["wi"][e]), p["wo"][e])
            out.index_add_(0, rows, (gate * chose)[rows].sum(-1)[:, None]
                           * ye)
        return out.view(Bsz, T, d)


# ------------------------------------------------------------------- counts
def _mamba_leaves(m: Mapping[str, Any]) -> Tuple[int, int]:
    """(elements, of which fp32) of one Mamba-2 mixer."""
    s, d = m["ssm"], m["d_model"]
    di = s["expand"] * d
    H, GN = di // s["head_dim"], s["n_groups"] * s["state_dim"]
    conv = (s["conv_width"] + int(s["conv_bias"])) * (di + 2 * GN)
    fp32 = 3 * H + di
    return d * (2 * di + 2 * GN + H) + conv + fp32 + di * d, fp32


def _attention_leaves(m: Mapping[str, Any]) -> int:
    d, hd = m["d_model"], m["head_dim"]
    return d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])


def _moe_leaves(m: Mapping[str, Any]) -> Tuple[int, int, int]:
    """(router, routed experts, shared expert) elements of one layer."""
    mo, d = m["moe"], m["d_model"]
    return (d * mo["n_experts"], mo["n_experts"] * 3 * d * mo["d_ff"],
            3 * d * mo["shared_d_ff"])


def leaves(m: Mapping[str, Any]) -> Dict[str, int]:
    """Elements of each weight group: the embedding table, each layer's
    norms and MoE (``layers``), the Mamba-2 and the attention mixers, the
    final norm."""
    d, L = m["d_model"], m["n_layers"]
    return {"embed": m["padded_vocab"] * d,
            "layers": L * (2 * d + sum(_moe_leaves(m))),
            "ssm": _count(m, "mamba") * _mamba_leaves(m)[0],
            "attn": _count(m, "attention") * _attention_leaves(m),
            "final_norm": d}


def flops_params(m: Mapping[str, Any]) -> int:
    """N of "2 N a token": every weight but the routed experts a token
    does not choose (``top_k`` of ``n_experts`` a layer run)."""
    mo = m["moe"]
    idle = mo["n_experts"] - mo["top_k"]
    return sum(leaves(m).values()) \
        - m["n_layers"] * idle * 3 * m["d_model"] * mo["d_ff"]


def weight_elements(m: Mapping[str, Any]) -> Tuple[int, int]:
    """(elements in the weights' type, fp32 elements) a decode step reads:
    the token rows of the (tied) table and every weight, each expert's
    once; the norm scales, the router and each mixer's ``A_log``, ``D``,
    ``dt_bias`` and gated-norm scale are fp32."""
    d, L = m["d_model"], m["n_layers"]
    lv = leaves(m)
    fp32 = L * (2 * d + _moe_leaves(m)[0]) \
        + _count(m, "mamba") * _mamba_leaves(m)[1] + d
    n = m["vocab_size"] * d + sum(lv.values()) - lv["embed"] - fp32
    return n, fp32


def weight_bytes(m: Mapping[str, Any], dtype: str) -> int:
    n, fp32 = weight_elements(m)
    return n * SIZE[dtype] + fp32 * 4


def state_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """One slot's SSM state (fp32) and conv state (the activations' type),
    over the Mamba-2 layers."""
    s, d = m["ssm"], m["d_model"]
    di = s["expand"] * d
    H, GN = di // s["head_dim"], s["n_groups"] * s["state_dim"]
    per = 4 * H * s["head_dim"] * s["state_dim"] \
        + SIZE[dtype] * (s["conv_width"] - 1) * (di + 2 * GN)
    return _count(m, "mamba") * per


def kv_row_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """One position's K and V over the attention layers."""
    return _count(m, "attention") * 2 * m["n_kv_heads"] * m["head_dim"] \
        * SIZE[dtype]

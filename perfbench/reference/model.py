"""Plain PyTorch forward of the benchmark's models, in fp32: Mamba-2
(arXiv:2405.21060) and Zamba2 (arXiv:2411.15242), as the configuration
files under ``perfbench/configs`` state them.

No kernel, cache or batching of the program: the SSD is the chunked
closed form of the Mamba-2 paper (its "minimal" listing: quadratic within a
chunk, a scan of chunk states between chunks), the causal conv a sum of
shifted products, attention a masked softmax of full scores. It reads the
weights the benchmark made, in the program's layout (layer-stacked
leaves), and upcasts each to fp32 where it is used; it imports nothing of
the program.

Departures from the published models, shared with the program under test:
no biases anywhere (Mamba-2's conv and projections, Zamba2's attention),
the LoRA adapters of Zamba2's shared block left out, and each shared-block
site with its own output projector of width ``2 d -> d``.

``precision`` selects how each weight product is computed: ``"fp32"`` (the
reference), ``"tf32"`` (fp32 operands on TF32 tensor cores) or ``"fp8"``
(both operands rounded to float8 e4m3 with one scale a tensor, the
product in fp32): the lower precisions are the controls of the output
checks (``reference/check.py``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
_FP8_MAX = 448.0


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for every fp32 product inside, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-12) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Model:
    """The fp32 model of one configuration file's ``model`` section."""

    def __init__(self, model: Mapping[str, Any],
                 precision: str = "fp32") -> None:
        if precision not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m = dict(model)
        self.precision = precision

    # ------------------------------------------------------------- pieces
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for a weight ``w`` (any layout flattened to 2-D
        beforehand), in the model's precision."""
        w = w.float()
        if self.precision == "fp8":
            return _fp8(x) @ _fp8(w)
        return x @ w

    def rmsnorm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m["norm_eps"]) * scale.float()

    @staticmethod
    def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Causal depthwise conv of ``x (B, T, C)`` with ``w (W, C)``:
        out[t] = sum_i w[i] x[t - (W - 1) + i], zeros before the start."""
        W, T = w.shape[0], x.shape[1]
        xp = F.pad(x, (0, 0, W - 1, 0))
        w = w.float()
        out = xp[:, 0:T] * w[0]
        for i in range(1, W):
            out = out + xp[:, i:i + T] * w[i]
        return out

    @staticmethod
    def _segsum(a: torch.Tensor) -> torch.Tensor:
        """``a (..., Q)`` -> ``(..., Q, Q)``: sum of a[j+1..i] at (i, j),
        -inf above the diagonal."""
        Q = a.shape[-1]
        a = a[..., None].expand(*a.shape, Q)
        mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                     device=a.device), diagonal=-1)
        a = a.masked_fill(~mask, 0)
        s = torch.cumsum(a, dim=-2)
        keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                     device=a.device))
        return s.masked_fill(~keep, float("-inf"))

    def ssd(self, x, dt, A, Bm, Cm, D) -> torch.Tensor:
        """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
        y_t = h_t C_t + D x_t, from a zero state, in chunks.
        x (B, T, H, P), dt (B, T, H), A (H,), Bm/Cm (B, T, H, N)."""
        Bsz, T, H, P = x.shape
        Q = self.m["ssm"]["chunk_size"]
        pad = (-T) % Q
        if pad:
            # dt = 0 on the padding: no input, no decay, nothing read back
            x, dt, Bm, Cm = (F.pad(t, (0,) * (2 * (t.ndim - 2)) + (0, pad))
                             for t in (x, dt, Bm, Cm))
        c = x.shape[1] // Q
        X = (x * dt[..., None]).reshape(Bsz, c, Q, H, P)
        a = (dt * A).reshape(Bsz, c, Q, H).permute(0, 3, 1, 2)  # b h c l
        Bc = Bm.reshape(Bsz, c, Q, H, -1)
        Cc = Cm.reshape(Bsz, c, Q, H, -1)
        a_cs = torch.cumsum(a, dim=-1)
        Lm = torch.exp(self._segsum(a))                          # b h c l s
        CB = torch.einsum("bclhn,bcshn->bhcls", Cc, Bc)
        y = torch.einsum("bhcls,bcshp->bclhp", CB * Lm, X)
        decay = torch.exp(a_cs[..., -1:] - a_cs)                 # b h c l
        states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay, X)
        states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
        chunk_decay = torch.exp(self._segsum(
            F.pad(a_cs[..., -1], (1, 0))))                       # b h z c
        states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)
        y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, states[:, :-1],
                             torch.exp(a_cs))
        y = y.reshape(Bsz, c * Q, H, P)[:, :T]
        return y + x[:, :T] * D.float()[:, None]

    def ssm_block(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        s = self.m["ssm"]
        Bsz, T, d = h.shape
        di = s["expand"] * d
        P, N, G = s["head_dim"], s["state_dim"], s["n_groups"]
        H = di // P
        z = self.mm(h, p["wz"])
        xs = F.silu(self.conv(self.mm(h, p["wx"]), p["conv_x"]))
        Bs = F.silu(self.conv(self.mm(h, p["wB"]), p["conv_B"]))
        Cs = F.silu(self.conv(self.mm(h, p["wC"]), p["conv_C"]))
        dt = F.softplus(self.mm(h, p["wdt"]) + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())

        def heads(t):   # (B, T, G*N) -> (B, T, H, N), a group per H/G heads
            return t.reshape(Bsz, T, G, 1, N).expand(
                Bsz, T, G, H // G, N).reshape(Bsz, T, H, N)
        y = self.ssd(xs.reshape(Bsz, T, H, P), dt, A, heads(Bs), heads(Cs),
                     p["D"])
        y = y.reshape(Bsz, T, di) * F.silu(z)
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True)
                            + self.m["norm_eps"]) * p["norm_scale"].float()
        return self.mm(y, p["wo"])

    def attention(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        """Causal multi-head attention with rotary positions 0..T-1."""
        Bsz, T, w = h.shape
        hd = self.m["head_dim"]
        nh, kv = self.m["n_heads"], self.m["n_kv_heads"]
        q = self.mm(h, p["wq"].reshape(w, -1)).view(Bsz, T, nh, hd)
        k = self.mm(h, p["wk"].reshape(w, -1)).view(Bsz, T, kv, hd)
        v = self.mm(h, p["wv"].reshape(w, -1)).view(Bsz, T, kv, hd)
        freqs = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=h.device)
            / hd))
        ang = torch.arange(T, device=h.device, dtype=torch.float32)[:, None] \
            * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

        def rope(t):
            t1, t2 = t.chunk(2, dim=-1)
            return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], -1)
        q, k = rope(q), rope(k)
        if kv != nh:
            k = k.repeat_interleave(nh // kv, dim=2)
            v = v.repeat_interleave(nh // kv, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # B, H, T, hd
        causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
        outs = []
        for s in range(0, T, 1024):    # query blocks bound the scores
            sc = (q[:, :, s:s + 1024] @ k.transpose(-1, -2)) * hd ** -0.5
            sc = sc.masked_fill(~causal[s:s + 1024], float("-inf"))
            outs.append(torch.softmax(sc, dim=-1) @ v)
        o = torch.cat(outs, dim=2).transpose(1, 2).reshape(Bsz, T, nh * hd)
        return self.mm(o, p["wo"].reshape(nh * hd, w))

    def mlp(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        return self.mm(F.silu(self.mm(h, p["wg"])) * self.mm(h, p["wi"]),
                       p["wo"])

    # ------------------------------------------------------------- model
    @staticmethod
    def _layer(tree: Any, i: int) -> Any:
        if isinstance(tree, dict):
            return {k: Model._layer(v, i) for k, v in tree.items()}
        return tree[i]

    def hidden(self, params: Params, tokens: torch.Tensor,
               layer_fn=None) -> torch.Tensor:
        """The final-normed hidden states ``(B, T, d)`` of ``tokens``.
        ``layer_fn(fn, *args)`` may wrap each layer (the trainer's
        reference checkpoints them)."""
        run = layer_fn or (lambda fn, *a: fn(*a))
        x = F.embedding(tokens.long(), params["embed"]["tokens"]).float()
        x0 = x
        every = self.m.get("hybrid_attn_every")
        site = 0
        for i in range(self.m["n_layers"]):
            lp = self._layer(params["layers"], i)
            if self.m["family"] == "hybrid" and i % every == 0:
                x = run(self._shared, params["shared"], x, x0, site)
                site += 1
            x = run(self._ssm_layer, lp, x)
        return self.rmsnorm(x, params["final_norm"]["scale"])

    def _ssm_layer(self, lp: Params, x: torch.Tensor) -> torch.Tensor:
        return x + self.ssm_block(lp["ssm"], self.rmsnorm(
            x, lp["norm"]["scale"]))

    def _shared(self, sh: Params, x: torch.Tensor, x0: torch.Tensor,
                site: int) -> torch.Tensor:
        w_in = torch.cat([x, x0], dim=-1)
        w_mid = w_in + self.attention(
            sh["attn"], self.rmsnorm(w_in, sh["norm1"]["scale"]))
        w_out = w_mid + self.mlp(sh["mlp"], self.rmsnorm(
            w_mid, sh["norm2"]["scale"]))
        return x + self.mm(w_out, sh["proj"][site])

    def logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """Logits over the real vocabulary (the table's padded rows are no
        tokens)."""
        emb = params["embed"]["tokens"][:self.m["vocab_size"]]
        return self.mm(h, emb.t())

    def loss(self, params: Params, tokens: torch.Tensor,
             layer_fn=None) -> torch.Tensor:
        """Next-token cross-entropy: position t predicts token t+1, the
        last position predicts nothing; the mean over the rest."""
        h = self.hidden(params, tokens, layer_fn)[:, :-1]
        lg = self.logits(params, h)
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                               tokens[:, 1:].reshape(-1).long())


def forward_logits(model: Model, params: Params, tokens: torch.Tensor,
                   start: int) -> torch.Tensor:
    """Logits ``(B, T - start, V)`` at positions ``start..T-1`` of
    ``tokens (B, T)``, without autograd."""
    with torch.no_grad(), tf32(model.precision == "tf32"):
        h = model.hidden(params, tokens)
        return model.logits(params, h[:, start:])

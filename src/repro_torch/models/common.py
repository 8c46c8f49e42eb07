"""Model configuration.

One ``ModelConfig`` covers every assigned family (dense / moe / ssm /
hybrid / moe_hybrid / audio enc-dec / vlm). Architecture files in
``repro_torch/configs`` instantiate it with the exact published
dimensions; ``reduced()`` derives the CPU smoke-test configuration.

The port's copy of the reference ``ModelConfig``: every field and derived
property is kept so configurations read the same in both packages; dtypes
are ``torch.dtype``s. Sharding-only fields (``gather_weights``,
``head_pad_to``, ``vocab_pad_to``) keep their meaning for shapes; the port
runs on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

# ---------------------------------------------------------------- families
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
#: granite-4.0-h: a mixer per layer (Mamba-2 or NoPE GQA, ``layer_types``),
#: each followed by an MoE block
MOE_HYBRID = "moe_hybrid"
AUDIO = "audio"   # encoder-decoder, stub audio frontend
VLM = "vlm"       # decoder LM, stub vision frontend


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    d_ff: int = 0               # per-expert hidden dim
    shared_d_ff: int = 0        # shared-expert hidden dim (0 = none)
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32
    #: "einsum"   = GShard one-hot dispatch (baseline; sharding-friendly,
    #:             pays one-hot matmul FLOPs)
    #: "scatter"  = sort/scatter dispatch (optimized; no dispatch FLOPs)
    #: "dropless" = every assignment runs: sorted by expert, grouped
    #:             products over each expert's rows (no capacity)
    dispatch: str = "einsum"
    #: tokens per routing group (GShard G×S grouping); 0 = one seq per group
    group_size: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk_size: int = 256       # SSD chunked-scan block length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = DENSE
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0           # 0 → d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    #: sliding-window attention size; 0 = full attention
    window: int = 0
    #: command-r style parallel attn+MLP block sharing one pre-norm
    parallel_block: bool = False
    #: tie input embedding and LM head (true for small models)
    tied_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): shared transformer block every k SSM layers,
    # operating on concat(x, x0) at width 2·d_model
    hybrid_attn_every: int = 6
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    max_target_len: int = 448
    #: frontend stub: inputs are precomputed embeddings of this dim
    frontend_dim: int = 0
    #: vlm: number of prepended patch-embedding positions
    n_patches: int = 0

    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    #: scan over stacked layers (compile-time/memory win) vs python loop
    scan_layers: bool = True
    #: remat policy for the layer body: "none" | "full" | "dots"
    remat: str = "full"
    #: attention implementation: "xla" | "pallas" | "pallas_interpret"
    attn_impl: str = "xla"
    #: §Perf optimization: bf16 score/softmax tensors with fp32 reductions
    #: + bf16-applied RoPE (flash-attention numerics). False = baseline.
    lean_attention: bool = False
    #: §Perf optimization: ZeRO-3-style just-in-time weight all-gather —
    #: un-shard the fsdp dim of each weight at its use site so matmuls
    #: contract replicated dims (weight gathers, small) instead of psum-ing
    #: activation-sized partial sums. False = baseline.
    gather_weights: bool = False
    #: pad attention heads up to a multiple of this for TP divisibility
    #: (DESIGN.md §5: llama4 40→48, deepseek 56→64, whisper 20→32)
    head_pad_to: int = 16
    #: pad the embedding table to a multiple of this (vocab must divide the
    #: TP degree; padded logits are masked to -inf — standard practice)
    vocab_pad_to: int = 128

    # the moe_hybrid family's settings, declared here once as plain class
    # attributes (the fields stay the reference's) at the values that leave
    # every other family as it is; ``MoEHybridConfig`` makes them required
    # fields
    layer_types = ()
    embedding_multiplier = 1.0
    residual_multiplier = 1.0
    attention_multiplier = None    # None: head_dim^-1/2
    logits_scaling = 1.0
    conv_bias = False

    # ----------------------------------------------------------- derived
    @property
    def kv_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attn_scale(self) -> float:
        """The attention softmax's scale of q·k."""
        if self.attention_multiplier is None:
            return self.resolved_head_dim ** -0.5
        return self.attention_multiplier

    @property
    def mixers(self) -> Tuple[Tuple[str, int], ...]:
        """A moe_hybrid stack's (kind, index) a layer: its mixer's kind and
        its place among the layers of that kind (the row of that kind's
        stacked weights and cache)."""
        seen = {"mamba": 0, "attention": 0}
        out = []
        for kind in self.layer_types:
            out.append((kind, seen[kind]))
            seen[kind] += 1
        return tuple(out)

    def n_mixers(self, kind: str) -> int:
        return sum(1 for k in self.layer_types if k == kind)

    @property
    def padded_heads(self) -> int:
        if self.head_pad_to <= 1:
            return self.n_heads
        return math.ceil(self.n_heads / self.head_pad_to) * self.head_pad_to

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to <= 1:
            return self.vocab_size
        return math.ceil(self.vocab_size / self.vocab_pad_to) * self.vocab_pad_to

    @property
    def padded_kv_heads(self) -> int:
        """KV heads after TP padding.

        GQA (groups > 1): kv heads stay real — q-head padding is
        distributed *within* each kv group (llama4 40→48 = 8 groups of
        5 real + 1 pad; deepseek 56→64 = 8×(7+1)). MHA (groups == 1,
        whisper 20→32): kv pads alongside q. Padded slots carry zero
        q/o weights, so the computed function is exactly the unpadded
        architecture (unit-tested)."""
        if self.n_kv_heads and self.padded_heads % self.n_kv_heads == 0 \
                and self.kv_groups > 1:
            return self.n_kv_heads
        return max(1, self.padded_heads // max(self.kv_groups, 1))

    @property
    def padded_kv_groups(self) -> int:
        return self.padded_heads // self.padded_kv_heads if self.n_heads \
            else 1

    @property
    def is_encdec(self) -> bool:
        return self.family == AUDIO

    @property
    def attn_free(self) -> bool:
        return self.family == SSM

    @property
    def hybrid_sites(self) -> int:
        """Shared-block sites of a hybrid stack: the block runs before
        layers 0, every, 2·every, ..., so ceil(L / every) times, each with
        its own output projector. The reference makes (and counts) L //
        every projectors and clamps the last site's index onto the one
        before it when every does not divide L (ROADMAP C.7)."""
        return max(1, -(-self.n_layers // self.hybrid_attn_every))

    @property
    def ssm_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.ssm_inner // self.ssm.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline terms)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tied_embeddings else 2)

        def attn_params(width: int, heads: int, kv: int) -> int:
            return (width * heads * hd + 2 * width * kv * hd
                    + heads * hd * width)

        def mlp_params(width: int, ff: int) -> int:
            return 3 * width * ff  # gated (SwiGLU)

        if self.family == SSM:
            s = self.ssm
            di = self.ssm_inner
            per = (d * (2 * di + 2 * s.n_groups * s.state_dim + self.ssm_heads)
                   + s.conv_width * (di + 2 * s.n_groups * s.state_dim)
                   + 2 * self.ssm_heads + di   # A, D, dt_bias + gated-norm
                   + di * d)
            return emb + self.n_layers * (per + d)
        if self.family == HYBRID:
            s = self.ssm
            di = self.ssm_inner
            per = (d * (2 * di + 2 * s.n_groups * s.state_dim + self.ssm_heads)
                   + s.conv_width * (di + 2 * s.n_groups * s.state_dim)
                   + 2 * self.ssm_heads + di + di * d)
            w = 2 * d   # shared block width
            # one projector per site (``hybrid_sites``); the reference
            # counts L // every
            shared = (attn_params(w, self.n_heads, self.n_kv_heads)
                      + mlp_params(w, self.d_ff) + 2 * w
                      + self.hybrid_sites * (w * d))
            return emb + self.n_layers * (per + d) + shared
        if self.family == MOE_HYBRID:
            s, m = self.ssm, self.moe
            di, G, N = self.ssm_inner, s.n_groups, s.state_dim
            mamba = (d * (2 * di + 2 * G * N + self.ssm_heads)
                     + (s.conv_width + int(self.conv_bias)) * (di + 2 * G * N)
                     + 3 * self.ssm_heads + di + di * d)
            moe = (d * m.n_experts + m.n_experts * mlp_params(d, m.d_ff)
                   + (mlp_params(d, m.shared_d_ff) if m.shared_d_ff else 0))
            n_attn = self.n_mixers("attention")
            return (emb + d + self.n_layers * (moe + 2 * d)
                    + (self.n_layers - n_attn) * mamba
                    + n_attn * attn_params(d, self.n_heads, self.n_kv_heads))
        if self.family == AUDIO:
            per_enc = attn_params(d, self.n_heads, self.n_kv_heads) \
                + mlp_params(d, self.d_ff) + 2 * d
            per_dec = 2 * attn_params(d, self.n_heads, self.n_kv_heads) \
                + mlp_params(d, self.d_ff) + 3 * d
            return emb + self.n_enc_layers * per_enc \
                + self.n_dec_layers * per_dec + self.frontend_dim * d
        per = attn_params(d, self.n_heads, self.n_kv_heads) + 2 * d
        if self.moe is not None:
            m = self.moe
            per += d * m.n_experts                     # router
            per += m.n_experts * mlp_params(d, m.d_ff)
            if m.shared_d_ff:
                per += mlp_params(d, m.shared_d_ff)
        else:
            per += mlp_params(d, self.d_ff)
        n = emb + self.n_layers * per + d
        if self.family == VLM:
            n += self.frontend_dim * d                 # patch projector stub
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_like = self.param_count() \
            - self.n_layers * m.n_experts * 3 * self.d_model * m.d_ff
        return dense_like + self.n_layers * m.top_k * 3 * self.d_model * m.d_ff

    # ------------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 if self.family != HYBRID else 4),
            d_model=128,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            window=min(self.window, 64) if self.window else 0,
            scan_layers=self.scan_layers,
            remat="none",
            head_pad_to=1,
            vocab_pad_to=1,
            parallel_block=self.parallel_block,
            family=self.family,
            hybrid_attn_every=2,
            tied_embeddings=True,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff=128, shared_d_ff=128 if self.moe.shared_d_ff else 0)
        if self.family == MOE_HYBRID:
            # a whole period: one attention layer among Mamba-2 layers;
            # enough experts that top-3 routing is uneven
            kw.update(n_layers=4,
                      layer_types=("mamba", "mamba", "attention", "mamba"))
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=3, d_ff=64,
                shared_d_ff=128 if self.moe.shared_d_ff else 0)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk_size=32)
        if self.family == AUDIO:
            kw.update(n_enc_layers=2, n_dec_layers=2, max_target_len=32,
                      frontend_dim=64)
        if self.family == VLM:
            kw.update(frontend_dim=64, n_patches=16)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True, kw_only=True)
class MoEHybridConfig(ModelConfig):
    """A ``moe_hybrid`` stack (granite-4.0-h, model_type
    ``granitemoehybrid``): each layer is rmsnorm, its mixer (Mamba-2 or
    GQA attention, as ``layer_types`` says), the residual, rmsnorm, an MoE
    block (``moe``, with its shared expert), the residual. The fields the
    reference's ``ModelConfig`` lacks:

    * ``layer_types``: "mamba" or "attention", one a layer;
    * ``embedding_multiplier``: the token embedding is multiplied by it;
    * ``residual_multiplier``: each residual branch (mixer, MoE) is;
    * ``attention_multiplier``: the softmax scale of q·k;
    * ``logits_scaling``: the logits are divided by it;
    * ``conv_bias``: the Mamba-2 causal conv has a bias a channel.

    Each is given by the configuration (keyword-only, no default: the
    neutral values are ``ModelConfig``'s). Attention without positions
    (NoPE) is ``rope_theta = 0``."""

    family: str = MOE_HYBRID
    layer_types: Tuple[str, ...]
    embedding_multiplier: float
    residual_multiplier: float
    attention_multiplier: float
    logits_scaling: float
    conv_bias: bool

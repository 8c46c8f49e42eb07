"""Shared layers: norms, rotary embeddings, gated MLP, embeddings.

Counterpart of ``repro/models/layers.py``: plain functions on tensors with
the reference's parameter layouts (``wi``/``wg`` ``(d, ff)``, ``wo``
``(ff, d)``, embedding ``(V, d)``); ``*_specs`` builds the matching
logical-axis trees. ``gathered`` and ``constrain`` are the reference's
sharding annotations at its sites: without a mesh (one card, the serving
engine) they change nothing.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import rmsnorm as rms_kernel
from repro_torch.models.common import ModelConfig
from repro_torch.sharding import constrain, is_dtensor


def gathered(w: torch.Tensor, *tp_axes, gather: bool = False
             ) -> torch.Tensor:
    """ZeRO-3 just-in-time weight gather (§Perf ``gather_weights``):
    constrain the weight to its tensor-parallel-only sharding, forcing the
    partitioner to all-gather the fsdp shards at the use site instead of
    reducing activation-sized partials after the matmul."""
    if not gather:
        return w
    return constrain(w, *tp_axes)


# ---------------------------------------------------------------------- init
#: elements drawn at once by ``init_normal`` (1 GiB of fp32)
_INIT_CHUNK = 1 << 28


def init_normal(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """``normal * scale`` of ``shape`` in ``dtype``, drawn from ``gen`` in
    fp32 a chunk at a time: a stack of expert weights in bf16 (13 GB for
    8 layers of qwen3-moe's ``wi``) never has its fp32 draw whole on the
    card."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), _INIT_CHUNK):
        n = min(_INIT_CHUNK, flat.numel() - s)
        flat[s:s + n] = torch.randn(n, generator=gen, device=device) * scale
    return out


def init_rmsnorm(dev, *shape) -> Dict[str, torch.Tensor]:
    """An rmsnorm's fp32 scale of ones, of ``shape`` (the width, after any
    stacked axes)."""
    return {"scale": torch.ones(shape, dtype=torch.float32, device=dev)}


def init_mlp(cfg: ModelConfig, gen: torch.Generator, dev, width: int,
             d_ff: int, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """A SwiGLU MLP's ``wi``/``wg`` ``(width, d_ff)`` and ``wo`` ``(d_ff,
    width)`` at fan_in^-1/2, stacked on ``lead``."""
    def draw(shape, scale):
        return init_normal(gen, lead + shape, scale, cfg.param_dtype, dev)
    return {"wi": draw((width, d_ff), width ** -0.5),
            "wg": draw((width, d_ff), width ** -0.5),
            "wo": draw((d_ff, width), d_ff ** -0.5)}


def stack_specs(tree: Any) -> Any:
    """A logical-axis tree with a leading (replicated) layer axis on every
    leaf, as the parameters are stacked."""
    if isinstance(tree, dict):
        return {k: stack_specs(v) for k, v in tree.items()}
    return (None,) + tuple(tree)


def layer_views(params: Dict[str, Any], key: str = "layers"
                ) -> List[Dict[str, Any]]:
    """Per-layer parameter dicts, views into the stacked leaves of
    ``params[key]`` (an enc-dec's ``"encoder"`` and ``"decoder"``)."""
    def unbind(tree):
        if isinstance(tree, dict):
            parts = {k: unbind(v) for k, v in tree.items()}
            n = len(next(iter(parts.values())))
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return tree.unbind(0)
    return unbind(params[key])


# --------------------------------------------------------------------- norm
def rmsnorm_specs() -> Dict[str, Any]:
    return {"scale": (None,)}


def rmsnorm(params: Dict[str, Any], x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    # the kernel reads whole rows: under a mesh a partial sum or a split
    # width is settled here (XLA's partitioner does so where it sees fit)
    x = constrain(x, "batch", *([None] * (x.ndim - 1)))
    return rms_kernel.rmsnorm(x, params["scale"], eps=eps)


# --------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float,
                     device: Any = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)          # (head_dim/2,)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(cos, sin)`` of shape ``(..., S, 1, head_dim/2)`` for
    ``positions (..., S)``: computed once per forward and shared by every
    layer's q and k."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                      lean: bool = False) -> torch.Tensor:
    """Rotate ``x (..., S, heads, head_dim)`` by precomputed tables.
    ``lean`` applies the rotators in x's own dtype (the reference's §Perf
    variant); otherwise the rotation runs in fp32."""
    if lean:
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               lean: bool = False) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return apply_rope_tables(x, cos, sin, lean=lean)


# --------------------------------------------------------------- sinusoidal
def sinusoidal_pe(positions: torch.Tensor, width: int) -> torch.Tensor:
    """Fixed sinusoidal embedding of ``positions (...)``, fp32 ``(...,
    width)``: ``pos / 10000 ** (dim / width)`` for the even ``dim``, sines
    then cosines (concatenated, not interleaved), in the reference's
    operation order. The power is taken in fp64 and rounded once, as the
    reference's fp32 power is rounded (torch's fp32 ``pow`` is an ulp off
    in places, which moves a sine at position 1500 by 3e-5). ``positions``
    may be a device tensor (a captured decode step's position buffer):
    nothing is read on the host."""
    pos = positions.float()[..., None]
    dim = torch.arange(0, width, 2, dtype=torch.float32,
                       device=positions.device)
    angle = pos / torch.pow(10000.0, (dim / width).double()).float()
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def sinusoidal_positions(seq_len: int, width: int,
                         device: Any = None) -> torch.Tensor:
    """Whisper-style fixed positional embedding (encoder), ``(seq_len,
    width)``."""
    return sinusoidal_pe(torch.arange(seq_len, device=device), width)


# ---------------------------------------------------------------------- mlp
def mlp_specs() -> Dict[str, Any]:
    return {"wi": ("fsdp", "tp"), "wg": ("fsdp", "tp"), "wo": ("tp", "fsdp")}


def mlp(params: Dict[str, Any], x: torch.Tensor,
        gather: bool = False) -> torch.Tensor:
    """SwiGLU MLP with TP-sharded hidden dim."""
    wi = gathered(params["wi"], None, "tp", gather=gather)
    wg = gathered(params["wg"], None, "tp", gather=gather)
    wo = gathered(params["wo"], "tp", None, gather=gather)
    h = x @ wi.to(x.dtype)
    g = x @ wg.to(x.dtype)
    h = constrain(F.silu(g) * h, "batch", None, "tp")
    return h @ wo.to(x.dtype)


# ---------------------------------------------------------------- embedding
def init_embedding(cfg: ModelConfig, gen: torch.Generator,
                   dev) -> Dict[str, torch.Tensor]:
    """The token table ``(padded_vocab, d)`` at 0.02 and, untied, the head
    ``(d, padded_vocab)`` at d^-1/2 (the reference's ``init_embedding``)."""
    V, d = cfg.padded_vocab, cfg.d_model
    embed = {"tokens": init_normal(gen, (V, d), 0.02, cfg.param_dtype, dev)}
    if not cfg.tied_embeddings:
        embed["head"] = init_normal(gen, (d, V), d ** -0.5, cfg.param_dtype,
                                    dev)
    return embed


def embedding_specs(cfg: ModelConfig) -> Dict[str, Any]:
    p = {"tokens": ("fsdp", "tp")}
    if not cfg.tied_embeddings:
        # untied head: contract replicated d, produce vocab-sharded logits
        p["head"] = ("fsdp", "vocab")
    return p


def embed_tokens(params: Dict[str, Any], tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The tokens' rows of the table, in ``cfg.dtype``, times
    ``cfg.embedding_multiplier``."""
    emb = gathered(params["tokens"], None, "tp", gather=cfg.gather_weights)
    x = F.embedding(tokens, emb).to(cfg.dtype)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return constrain(x, "batch", None, None)


def lm_logits(params: Dict[str, Any], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Vocab-sharded logits over the (padded) vocabulary, divided by
    ``cfg.logits_scaling``; the padded tail is masked to ``-1e30``."""
    if cfg.tied_embeddings:
        emb = gathered(params["tokens"], "vocab", None,
                       gather=cfg.gather_weights)
        logits = x @ emb.to(cfg.dtype).t()
    else:
        head = gathered(params["head"], None, "vocab",
                        gather=cfg.gather_weights)
        logits = x @ head.to(cfg.dtype)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    if cfg.padded_vocab != cfg.vocab_size:
        vpos = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(vpos >= cfg.vocab_size, -1e30)
    return constrain(logits, "batch", None, "vocab")


# ------------------------------------------------------------------- loss
def next_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """The labels of next-token prediction: ``tokens`` rolled left by one
    along the sequence (the reference's ``jnp.roll(tokens, -1, axis=1)``),
    as a slice and a concatenation, which a sharded batch takes too."""
    return torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid tokens, in fp32: the row log-sum-exp minus the
    label's logit, averaged over ``mask`` (the reference's
    ``cross_entropy``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # vocab-sharded logits: each rank picks the labels in its own
        # columns, a sum over the vocab settles them (no gather of logits)
        vpos = torch.arange(logits.shape[-1], device=logits.device)
        hit = labels[..., None].long() == vpos
        label_logit = torch.where(hit, logits, 0.0).sum(dim=-1)
    else:
        label_logit = torch.gather(logits, -1,
                                   labels[..., None].long())[..., 0]
    nll = lse - label_logit
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()

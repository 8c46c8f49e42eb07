"""Assigned input shapes × architectures: specs and applicability
(counterpart of ``repro/launch/shapes.py``).

The four LM shapes (assignment):
    train_4k     seq 4096  × global_batch 256   → train_step
    prefill_32k  seq 32768 × global_batch 32    → prefill_step
    decode_32k   seq 32768 × global_batch 128   → serve_step (1 new token,
                                                  KV cache of seq_len)
    long_500k    seq 524288 × global_batch 1    → serve_step; sub-quadratic
                 archs only (SSM / hybrid / SWA) — full-attention archs skip

``input_specs`` returns meta tensors (shape and dtype, no storage) for
every model input, the counterpart of the reference's
``ShapeDtypeStruct``s. Per-arch microbatch counts keep train_4k activation
memory bounded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import AUDIO, HYBRID, SSM, VLM, ModelConfig

WHISPER_CROSS_LEN = 1500   # canonical whisper encoder output length


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode | long
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "long", 524288, 1),
}

# train_4k gradient-accumulation microbatches (global batch 256)
MICROBATCHES: Dict[str, int] = {
    "llama3-405b": 16,
    "command-r-plus-104b": 16,
    "deepseek-coder-33b": 8,
    "qwen3-moe-235b-a22b": 8,
    "internvl2-26b": 8,
    "llama4-scout-17b-a16e": 8,
    "h2o-danube-3-4b": 4,
    "zamba2-1.2b": 4,
    "mamba2-370m": 4,
    "whisper-large-v3": 4,
}


def microbatches_for(cfg: ModelConfig) -> int:
    return MICROBATCHES.get(cfg.name, 4)


def is_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.kind == "long":
        if cfg.family in (SSM, HYBRID):
            return True, "state-space decode: O(1) state"
        if cfg.window:
            return True, f"SWA decode: window-bounded cache ({cfg.window})"
        return False, ("full attention: 500k-token stream is the quadratic "
                       "regime this shape excludes (DESIGN.md §4)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta tensors for the step's *batch* inputs."""
    B, S = shape.global_batch, shape.seq_len
    tok = lambda b, s: _meta((b, s), torch.int32)        # noqa: E731
    emb = lambda *dims: _meta(dims, torch.bfloat16)      # noqa: E731
    if cfg.family == AUDIO:
        if shape.kind == "train":
            return {"audio_embed": emb(B, S, cfg.frontend_dim),
                    "dec_tokens": tok(B, min(cfg.max_target_len, 448))}
        if shape.kind == "prefill":
            return {"audio_embed": emb(B, S, cfg.frontend_dim)}
        return {"token": tok(B, 1)}                    # decode
    if cfg.family == VLM:
        if shape.kind in ("train", "prefill"):
            return {"tokens": tok(B, S - cfg.n_patches),
                    "patches": emb(B, cfg.n_patches, cfg.frontend_dim)}
        return {"token": tok(B, 1)}
    if shape.kind in ("train", "prefill"):
        return {"tokens": tok(B, S)}
    return {"token": tok(B, 1)}                        # decode / long


def cache_shape_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """KV cache length for serve shapes (SWA bounds it at the window)."""
    return shape.seq_len

"""The benchmark's weights: made from the run's seed, on the device, in
the type they are served or trained in, and handed to the program and to
the plain reference alike.

``make_params`` hands the configuration to its family's module
(``families/<family>.py``), which lays the tree out as the program does
(``repro_torch.models.lm``: per-layer leaves stacked on a leading layer
axis) and draws it with the helpers here: one ``torch.Generator`` on the
device seeded from the run's seed, each stacked leaf one draw from it in
fp32 blocks of at most 2**28 elements, scaled and cast to the weights'
type; norm scales and other fp32 leaves made as the family states. The
order of the draws is the family's, so a seed gives the same tensors in
every run.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from perfbench import families

_BLOCK = 1 << 28


def generator(seed: int, device: torch.device) -> torch.Generator:
    """The run's generator on ``device``, seeded from ``seed`` (any whole
    number; its low 64 bits)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return gen


def normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``normal * scale`` of ``shape`` in ``dtype``, drawn in fp32 blocks."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), _BLOCK):
        n = min(_BLOCK, flat.numel() - s)
        flat[s:s + n] = torch.randn(n, generator=gen, device=device) * scale
    return out


def ones(shape, device) -> torch.Tensor:
    """An fp32 leaf of ones (a norm scale, Mamba-2's ``D``)."""
    return torch.ones(shape, dtype=torch.float32, device=device)


def make_params(cfg: Any, seed: int, device: Any) -> Dict[str, Any]:
    """Weights of ``cfg`` (a ``repro_torch`` config) in
    ``cfg.param_dtype``, drawn from ``seed`` on ``device`` by its family's
    module."""
    return families.module(cfg.family).make_params(cfg, seed, device)

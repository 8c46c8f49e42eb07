"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any = "cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument. A CUDA
    device without a usable card raises: the port never falls back to the
    CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the GPU by default; "
            "pass device='cpu' to run its plain PyTorch versions on the CPU")
    return dev


def generator(dev: torch.device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` for draws on ``dev``; meta tensors
    (the dry run's, shapes without values) take a CPU one, which they
    never draw from."""
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(int(seed))
    return gen

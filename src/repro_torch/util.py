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

"""Global-norm gradient clipping (counterpart of ``repro/optim/clip.py``);
the norm stays a device tensor."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.tree import tree_leaves, tree_map


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """``(grads scaled to a global norm of at most max_norm, the raw
    norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm

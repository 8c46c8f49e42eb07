"""Parameters of a configuration's model, from its sizes (a
configuration file's ``model`` section), leaf group by leaf group as the
weights are laid out: each family's module (``families/<family>.py``)
counts its own."""
from __future__ import annotations

from typing import Any, Dict, Mapping

from perfbench import families


def leaves(m: Mapping[str, Any]) -> Dict[str, int]:
    """Elements of each weight group, as the family groups them."""
    return families.of(m).leaves(m)


def param_count(m: Mapping[str, Any]) -> int:
    return sum(leaves(m).values())


def flops_params(m: Mapping[str, Any]) -> int:
    """N of "2 N a token to infer, 6 N to train": every weight a token
    passes through (a weight used at several sites once a site)."""
    return families.of(m).flops_params(m)

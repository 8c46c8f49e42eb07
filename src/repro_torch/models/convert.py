"""Carry the reference package's weights over to the port.

``params_from_numpy(tree, cfg, device)`` takes the reference's parameter
pytree with every leaf already a numpy array (``jax.tree_util.tree_map(
np.asarray, params)``) and returns the port's parameter dict with the same
nesting and the same layouts, on ``device``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import SSM, ModelConfig
from repro_torch.util import resolve_device


def tensor_from_numpy(a: Any, device: Any = "cuda") -> torch.Tensor:
    """numpy → torch, including ``ml_dtypes.bfloat16`` arrays (which
    ``torch.from_numpy`` refuses): their bits are reinterpreted."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(resolve_device(device))


def params_from_numpy(tree: Any, cfg: ModelConfig,
                      device: Any = "cuda") -> Any:
    """The reference pytree (nested dicts of numpy leaves) as torch
    tensors on ``device``; nesting and layouts are unchanged. Raises when
    the tree does not have ``cfg``'s embedding, layer count or block form
    (a parallel block has no ``norm2``)."""
    dev = resolve_device(device)

    def convert(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    out = convert(tree)
    emb = tuple(out["embed"]["tokens"].shape)
    if emb != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"embedding {emb} does not fit {cfg.name}: "
                         f"expected {(cfg.padded_vocab, cfg.d_model)}")
    # a stacked leaf every layer of the family has
    probe = out["layers"]["ssm"]["wx"] if cfg.family == SSM \
        else out["layers"]["attn"]["wq"]
    if probe.shape[0] != cfg.n_layers:
        raise ValueError(f"{probe.shape[0]} stacked layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    if cfg.family != SSM and ("norm2" in out["layers"]) == cfg.parallel_block:
        has = "has" if cfg.parallel_block else "lacks"
        raise ValueError(f"{cfg.name} has parallel_block="
                         f"{cfg.parallel_block}, but the tree {has} norm2")
    return out

"""Carry the reference package's weights over to the port.

``params_from_numpy(tree, cfg, device)`` takes the reference's parameter
pytree with every leaf already a numpy array (``jax.tree_util.tree_map(
np.asarray, params)``) and returns the port's parameter dict with the same
nesting and the same layouts, on ``device``. The one change is a hybrid's
shared-block projectors: the reference makes ``n_layers // every`` of them
and its last site reuses the last one (JAX clamps the index; ROADMAP
C.7), the port one per site, so the last is repeated to the site count.
An audio enc-dec's tree has ``encoder`` and ``decoder`` stacks where a
decoder-only tree has ``layers``. ``train_state_from_numpy`` carries a
whole train state over (the reference's ``init_train_state`` tree: params,
the AdamW ``m``/``v``/``count`` and ``step``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.common import (AUDIO, HYBRID, MOE, SSM, VLM,
                                       ModelConfig)
from repro_torch.util import resolve_device


def tensor_from_numpy(a: Any, device: Any = "cuda") -> torch.Tensor:
    """numpy → torch, including ``ml_dtypes.bfloat16`` arrays (which
    ``torch.from_numpy`` refuses): their bits are reinterpreted."""
    a = np.asarray(a)
    # ascontiguousarray makes a 0-d array 1-d: keep the shape
    c = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(c.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(c.copy())
    return t.to(resolve_device(device))


def params_from_numpy(tree: Any, cfg: ModelConfig,
                      device: Any = "cuda") -> Any:
    """The reference pytree (nested dicts of numpy leaves) as torch
    tensors on ``device``; nesting and layouts are unchanged, but for a
    hybrid's projectors (the module's docstring). Raises when the tree
    does not have ``cfg``'s embedding, layer count, block form (a parallel
    block has no ``norm2``, an MoE block ``cfg.moe.n_experts`` experts in
    place of the MLP) or, for a hybrid, the reference's or the port's
    projector count; for an enc-dec, its encoder and decoder layer counts;
    for an enc-dec or a VLM, the frontend's ``(frontend_dim, d_model)``. A
    tree of another family (stacks of the other kind) raises too."""
    dev = resolve_device(device)

    def convert(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    encdec = cfg.family == AUDIO
    want, other = (("encoder", "decoder"), "layers") if encdec \
        else (("layers",), "encoder")
    if other in tree or not all(k in tree for k in want):
        raise ValueError(f"{cfg.name} is family {cfg.family!r}: its tree "
                         f"has {list(want)}, this one {sorted(tree)}")
    out = convert(tree)
    emb = tuple(out["embed"]["tokens"].shape)
    if emb != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"embedding {emb} does not fit {cfg.name}: "
                         f"expected {(cfg.padded_vocab, cfg.d_model)}")
    if encdec or cfg.family == VLM:
        proj = tuple(out["frontend"]["proj"].shape) \
            if "frontend" in out else None
        if proj != (cfg.frontend_dim, cfg.d_model):
            raise ValueError(f"frontend projector {proj} does not fit "
                             f"{cfg.name}: expected "
                             f"{(cfg.frontend_dim, cfg.d_model)}")
    if encdec:
        for stack, leaf, n in (("encoder", "attn", cfg.n_enc_layers),
                               ("decoder", "self_attn", cfg.n_dec_layers)):
            got = out[stack][leaf]["wq"].shape[0]
            if got != n:
                raise ValueError(f"{got} stacked {stack} layers, "
                                 f"{cfg.name} has {n}")
        return out
    layers = out["layers"]
    ssm_stack = cfg.family in (SSM, HYBRID)
    # a stacked leaf every layer of the family has
    probe = layers["ssm"]["wx"] if ssm_stack else layers["attn"]["wq"]
    if probe.shape[0] != cfg.n_layers:
        raise ValueError(f"{probe.shape[0]} stacked layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    if not ssm_stack and ("norm2" in layers) == cfg.parallel_block:
        has = "has" if cfg.parallel_block else "lacks"
        raise ValueError(f"{cfg.name} has parallel_block="
                         f"{cfg.parallel_block}, but the tree {has} norm2")
    if not ssm_stack and ("moe" in layers) != (cfg.family == MOE):
        raise ValueError(f"{cfg.name} is family {cfg.family!r}, but the "
                         f"tree's layers hold {sorted(layers)}")
    if cfg.family == MOE and layers["moe"]["wi"].shape[1] \
            != cfg.moe.n_experts:
        raise ValueError(f"{layers['moe']['wi'].shape[1]} experts, "
                         f"{cfg.name} has {cfg.moe.n_experts}")
    if cfg.family == HYBRID:
        proj = out["shared"]["proj"]
        n_ref = max(1, cfg.n_layers // cfg.hybrid_attn_every)
        if proj.shape[0] not in (n_ref, cfg.hybrid_sites):
            raise ValueError(
                f"{proj.shape[0]} shared-block projectors: {cfg.name} has "
                f"{cfg.hybrid_sites} sites (the reference makes {n_ref})")
        extra = cfg.hybrid_sites - proj.shape[0]
        out["shared"]["proj"] = torch.cat(
            [proj, proj[-1:].expand((extra,) + tuple(proj.shape[1:]))])
    return out


def train_state_from_numpy(tree: Any, cfg: ModelConfig,
                           device: Any = "cuda") -> Any:
    """The reference's train state ``{"params", "opt": {"m", "v",
    "count"}, "step"}`` (numpy leaves) as the port's: the params and both
    moments through ``params_from_numpy`` (a hybrid's moments get the
    projector repeat too), the counters as 0-d int32 tensors."""
    dev = resolve_device(device)
    opt = tree["opt"]
    return {"params": params_from_numpy(tree["params"], cfg, dev),
            "opt": {"m": params_from_numpy(opt["m"], cfg, dev),
                    "v": params_from_numpy(opt["v"], cfg, dev),
                    "count": tensor_from_numpy(
                        np.asarray(opt["count"], np.int32), dev)},
            "step": tensor_from_numpy(np.asarray(tree["step"], np.int32),
                                      dev)}

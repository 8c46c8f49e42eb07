"""AdamW with its state ``{"m", "v", "count"}`` shaped like the weights.

Counterpart of ``repro/optim/adamw.py``: the same update, written as
tensor ops in the reference's order (not ``torch.optim.AdamW``, which
applies its weight decay another way). ``state_dtype`` trades optimizer
memory for fidelity, as there. The update returns new tensors, as the
reference's does, and never writes its inputs: an asynchronous checkpoint
may still be copying the previous state off the card
(``checkpoint.async_ckpt``). The step counter and the bias corrections
stay on the device; nothing is read back on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.optim.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32


def adamw_init(params: Any, opt_cfg: OptConfig) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=opt_cfg.state_dtype,
                           device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_spec_tree: Any) -> Dict[str, Any]:
    """m and v shard exactly like the weights; count is replicated."""
    return {"m": param_spec_tree, "v": param_spec_tree, "count": ()}


def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any,
                 lr: torch.Tensor, opt_cfg: OptConfig):
    """One AdamW step: ``(new_params, new_opt_state)``. ``lr`` is a 0-d
    fp32 tensor (a schedule's value) or a float."""
    count = opt_state["count"] + 1
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    cf = count.float()
    # b ** count with b rounded to fp32 first, as the reference's weak-typed
    # Python float meets its fp32 count
    c1 = 1.0 - torch.pow(torch.full((), b1, device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.full((), b2, device=cf.device), cf)

    def upd(g, m, v, p):
        g = g.float()
        mf = m.float() * b1 + (1 - b1) * g
        vf = v.float() * b2 + (1 - b2) * g * g
        step = (mf / c1) / (torch.sqrt(vf / c2) + opt_cfg.eps)
        step = step + opt_cfg.weight_decay * p.float()
        new_p = (p.float() - lr * step).to(p.dtype)
        return new_p, mf.to(m.dtype), vf.to(v.dtype)

    with torch.no_grad():
        out = tree_map(upd, grads, opt_state["m"], opt_state["v"], params)

    def pick(i):
        return tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}

"""Train-step factory: microbatched gradient accumulation, global-norm
clipping, a schedule and AdamW.

Counterpart of ``repro/train/train_step.py`` on one device. The global
batch is split into ``num_microbatches`` along its first axis and the
fp32 gradients are summed over them in a loop (the reference's
``lax.scan``), then averaged. The step reads nothing back on the host: its
metrics ``loss``, ``grad_norm`` and ``lr`` are device tensors, so a loop
of steps never waits on the card (``launch.train`` reads the loss through
a continuation). The state is ``{"params", "opt": {"m", "v", "count"},
"step"}``, as the reference's; a step returns a new state and leaves the
old one as it was.

Under a mesh (``repro_torch.sharding.use_sharding`` around the step, the
state placed by ``train_state_specs``) the same step runs on DTensors;
``grad_spec_tree`` constrains each gradient to its weight's sharding, so
the data-parallel sync is a reduce-scatter rather than an all-reduce.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models import encdec, lm
from repro_torch.models.common import AUDIO, ModelConfig
from repro_torch.optim import (OptConfig, adamw_init, adamw_update,
                               clip_by_global_norm, constant, opt_state_specs)
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding import constrain, settle
from repro_torch.util import resolve_device


def default_loss_fn(cfg: ModelConfig) -> Callable:
    if cfg.family == AUDIO:
        return lambda p, b: encdec.encdec_loss(p, b, cfg)
    return lambda p, b: lm.lm_loss(p, b, cfg)


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig, seed: int = 0,
                     device: Any = "cuda") -> Dict[str, Any]:
    """Random weights from ``seed`` (the port's ``init_params``, not the
    reference's numbers: ``convert.train_state_from_numpy`` carries those
    over), zeroed AdamW state and step 0, on ``device``."""
    init_fn = encdec.init_params if cfg.family == AUDIO else lm.init_params
    params = init_fn(cfg, seed=seed, device=resolve_device(device))
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def train_state_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs_fn = encdec.param_specs if cfg.family == AUDIO else lm.param_specs
    pspecs = specs_fn(cfg)
    return {"params": pspecs, "opt": opt_state_specs(pspecs), "step": ()}


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *,
                    num_microbatches: int = 1,
                    lr_schedule: Optional[Callable] = None,
                    loss_fn: Optional[Callable] = None,
                    grad_spec_tree: Any = None) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``; ``batch`` is a
    dict of tensors on the state's device with the global batch first.

    ``grad_spec_tree``: logical-axis tree (= param specs). When given,
    per-microbatch gradients are constrained to the weight sharding, which
    lowers the data-parallel sync as reduce-scatters instead of full
    all-reduces (the reference's §Perf optimization)."""
    loss_fn = loss_fn or default_loss_fn(cfg)
    lr_schedule = lr_schedule or constant(opt_cfg.lr)

    def _constrain_grads(grads):
        if grad_spec_tree is None:
            # under a mesh: partial sums all-reduced (the reference's
            # data-parallel sync without the constraint)
            return tree_map(settle, grads)
        return tree_map(lambda g, axes: constrain(g, *axes), grads,
                        grad_spec_tree)

    def grads_of(params, batch):
        with torch.enable_grad():
            watched = tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
            loss = loss_fn(watched, batch)
            grads = torch.autograd.grad(loss, tree_leaves(watched))
        return loss.detach(), _constrain_grads(
            tree_unflatten(params, (g.float() for g in grads)))

    def train_step(state, batch):
        params = state["params"]
        if num_microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            loss = grads = None
            for j in range(num_microbatches):
                mb = {k: constrain(v.reshape((num_microbatches, -1)
                                             + tuple(v.shape[1:]))[j],
                                   "batch", *([None] * (v.ndim - 1)))
                      for k, v in batch.items()}
                mloss, mgrads = grads_of(params, mb)
                if grads is None:
                    loss, grads = mloss, mgrads
                else:
                    loss = loss + mloss
                    grads = tree_map(torch.add, grads, mgrads)
            inv = 1.0 / num_microbatches
            loss = loss * inv
            grads = tree_map(lambda g: g * inv, grads)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        lr = lr_schedule(state["step"])
        new_params, new_opt = adamw_update(grads, state["opt"], params, lr,
                                           opt_cfg)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return new_state, metrics

    return train_step

"""The plain reference of a train cell's first steps: the fp32 model of
the configuration's family (``reference.model.build``), its loss and
gradients by autograd, global-norm clipping and AdamW, written out here
(``torch.optim`` applies weight decay another way).

It starts from the weights the benchmark made (a host copy taken before
the program's first step) and the same batches, and returns what the
output check compares: each step's loss, the per-leaf norms of the first
gradient as the optimizer gets it (after clipping), and the per-leaf norms
of the weights' change after the steps. Rows are run a block at a time
and each layer is recomputed in the backward, so the largest cell fits
beside nothing else; the gradient is the token-weighted sum of the
blocks'.

``precision="tf32"`` is the control of an fp32 configuration; ``rows``
(a subset of each batch's rows, the mean taken over them alone) plants the
fault "half of the batch left out".
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch.utils import checkpoint

from perfbench.reference.model import build, tf32


def flat(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflat(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def leaf_norms(tree: Any) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in flat(tree).items()}


def reference_steps(model: Mapping[str, Any], params0: Any,
                    batches: Sequence[np.ndarray], opt: Mapping[str, float],
                    device: Any, precision: str = "fp32",
                    rows: Optional[Sequence[int]] = None,
                    block_rows: int = 1) -> Dict[str, Any]:
    """Run ``len(batches)`` train steps from ``params0`` (a tree of host
    tensors); returns ``{"loss": [...], "grad": {leaf: norm},
    "update": {leaf: norm}}``."""
    ref = build(model, precision)
    p0 = {k: v for k, v in flat(params0).items()}
    p = {k: v.to(device=device, dtype=torch.float32) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, clip = opt["lr"], opt["weight_decay"], opt["grad_clip"]
    out: Dict[str, Any] = {"loss": []}

    def layer(fn, *args):
        return checkpoint.checkpoint(fn, *args, use_reentrant=False)

    for step, batch in enumerate(batches, start=1):
        toks = torch.as_tensor(np.asarray(batch), device=device)
        if rows is not None:
            toks = toks[list(rows)]
        n = toks.shape[0]
        grads = {k: torch.zeros_like(t) for k, t in p.items()}
        loss_sum = 0.0
        with tf32(precision == "tf32"):
            for s in range(0, n, block_rows):
                blk = toks[s:s + block_rows]
                watched = {k: t.detach().requires_grad_(True)
                           for k, t in p.items()}
                loss = ref.loss(unflat(watched), blk, layer)
                w = blk.shape[0] / n
                gs = torch.autograd.grad(loss * w, list(watched.values()))
                for k, g in zip(watched, gs):
                    grads[k] += g
                loss_sum += float(loss.detach()) * w
                del loss, gs, watched
        out["loss"].append(loss_sum)
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = torch.clamp(clip / gnorm.clamp_min(1e-9), max=1.0)
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for k in p:
                g = grads[k] * scale
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                upd = (m[k] / c1) / (torch.sqrt(v2[k] / c2) + eps) \
                    + wd * p[k]
                p[k] = p[k] - lr * upd
            if step == 1:
                out["grad"] = {k: float(m[k].norm()) / (1 - b1) for k in m}
        del grads
    out["update"] = {k: float((p[k] - p0[k].to(device=device,
                                                dtype=torch.float32)).norm())
                     for k in p}
    return out


def compare(prog: Mapping[str, Any], ref: Mapping[str, Any],
            leaf_floor: float = 1e-3) -> Dict[str, float]:
    """The numbers the check compares: the largest relative gap of a
    step's loss, and by the worst leaf, the gap between the program's and
    the reference's norm of the first gradient and of the change, against
    the reference's norm of that leaf or of the median leaf, whichever is
    larger. Leaves whose reference gradient is under ``leaf_floor`` of the
    median leaf's (nought to rounding) are left out of both."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                    ref["loss"]))
    gmed = float(np.median(list(ref["grad"].values())))
    keep = [k for k, g in ref["grad"].items() if g >= leaf_floor * gmed]

    def worst(key: str) -> float:
        med = float(np.median([ref[key][k] for k in keep]))
        return max(abs(prog[key][k] - ref[key][k])
                   / max(ref[key][k], med) for k in keep)
    return {"loss": loss, "grad": worst("grad"), "update": worst("update")}

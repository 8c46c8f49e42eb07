"""Elastic scaling: shrink/regrow the mesh and re-shard state.

Counterpart of ``repro/runtime/elastic.py``. At 1000+ cards the failure
model is "a pod (or slice) drops out"; recovery is: detect (heartbeat) →
rebuild the mesh on the surviving ranks → restore the latest committed
checkpoint re-sharded onto the new mesh → resume. ``reshard_state`` also
serves planned elastic *expansion* (a new pod joins): the same state
restores onto the larger mesh.

Every rank of the process group calls each function (a ``DeviceMesh`` is
built collectively, and so is a re-shard), also a rank the new mesh leaves
out; such a rank holds no shard of the result.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.optim.tree import tree_map
from repro_torch.sharding import specs_to_shardings


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(ranks: Sequence[int], shape: Tuple[int, ...],
               axes: Tuple[str, ...], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` of
    ``ranks`` (of the default process group), named ``axes``."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if len(ranks) < n:
        raise ValueError(f"need {n} ranks, have {len(ranks)}")
    arr = torch.tensor(list(ranks[:n]), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type or _device_type(), arr,
                      mesh_dim_names=tuple(axes))


def shrink_after_failure(ranks: Sequence[int], shape: Tuple[int, ...],
                         axes: Tuple[str, ...], failed: Sequence[int],
                         device_type: Optional[str] = None
                         ) -> Tuple[Any, Tuple[int, ...]]:
    """Drop the outermost-axis slices containing failed ranks and rebuild.

    The outermost axis is the scale-out axis ("pod" on the production
    mesh): losing any card in a pod evicts that pod."""
    arr = torch.tensor(list(ranks[:math.prod(shape)])).reshape(shape)
    bad = set(int(r) for r in failed)
    keep = [arr[i] for i in range(shape[0])
            if not bad & set(arr[i].flatten().tolist())]
    if not keep:
        raise RuntimeError("no surviving slices")
    new_shape = (len(keep),) + tuple(shape[1:])
    kept = torch.stack(keep).flatten().tolist()
    return build_mesh(kept, new_shape, axes, device_type), new_shape


def _whole(x: Any) -> torch.Tensor:
    """Every rank's copy of the whole of leaf ``x``: a plain tensor as it
    is (each rank passes the same one, as a checkpoint restore gives it);
    a DTensor gathered on its mesh (``full_tensor``) and broadcast from
    that mesh's first rank to the ranks outside it."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    member = mesh.get_coordinate() is not None
    if member:
        full = x.full_tensor()
    else:
        dev = "cuda" if mesh.device_type == "cuda" else "cpu"
        full = torch.empty(x.shape, dtype=x.dtype, device=dev)
    src = int(mesh.mesh.flatten()[0])
    dist.broadcast(full, src=src)
    return full


def reshard_state(state: Any, spec_tree: Any, new_mesh: Any,
                  rules: Optional[Dict] = None,
                  overrides: Optional[Dict] = None) -> Any:
    """Re-place every leaf onto the new mesh per its logical spec: the
    whole leaf (``full_tensor()``), then ``distribute_tensor`` from each
    rank's own copy (no scatter)."""
    from torch.distributed.tensor import distribute_tensor
    shardings = specs_to_shardings(spec_tree, new_mesh, rules, overrides)

    def put(x, sharding):
        mesh, placements = sharding
        return distribute_tensor(_whole(x), mesh, placements,
                                 src_data_rank=None)

    return tree_map(put, state, shardings)

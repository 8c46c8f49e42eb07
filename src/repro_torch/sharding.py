"""Logical-axis sharding: the rules table and the constraint helper.

Counterpart of ``repro/sharding.py``. Model code names the axes of its
activations and weights *logically* (``"batch"``, ``"heads"``, ``"tp"``);
a rules table maps each name to mesh axes (MaxText-style). A
``torch.distributed.device_mesh.DeviceMesh`` stands where the reference's
``jax.sharding.Mesh`` stands, DTensor placements (``Shard``,
``Replicate``) where its ``PartitionSpec`` / ``NamedSharding`` stand, and
``DTensor.redistribute`` where ``with_sharding_constraint`` stands.

Outside a ``use_sharding`` context, and on a plain tensor, every helper is
a no-op: the serving engine and the step graphs never see a mesh, and the
same model code runs on one card, on a mesh of processes, and in the dry
run's fake 256/512-rank mesh.

``logical_to_spec`` returns a plain tuple, one entry per tensor dimension
(``None``, a mesh axis name, or a tuple of them), equal to the reference's
``PartitionSpec`` taken as a tuple. ``placements_for`` turns such a spec
into one placement per mesh dimension.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.optim.tree import tree_map

Logical = Union[str, None, Tuple[Union[str, None], ...]]
Spec = Tuple[Any, ...]

# Default rules: single-pod (data, model) and multi-pod (pod, data, model)
# meshes share one table — "replica" composes pod×data when present.
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "tp": "model",
    "vocab": "model",
    "expert": "model",
    "heads": "model",
    "act_heads": "model",
    "seq": None,          # overridden to ("pod", "data") for long-context SP
    "kv_seq": None,
    "chunk": None,
    "state": None,
}

_CTX = threading.local()


def _current() -> Optional[Tuple[Any, Dict[str, Any]]]:
    return getattr(_CTX, "ctx", None)


def current_mesh() -> Optional[Any]:
    """The active ``DeviceMesh`` of this thread, or None."""
    ctx = _current()
    return None if ctx is None else ctx[0]


@contextlib.contextmanager
def use_sharding(mesh: Optional[Any], rules: Optional[Dict[str, Any]] = None,
                 overrides: Optional[Dict[str, Any]] = None):
    """Activate a mesh + logical rules for model code in this thread.

    Inside, plain tensors that meet DTensors (masks, position tables made
    with ``torch.arange``) are taken as replicated, as a value outside any
    sharding is in the reference's program."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _current()
    _CTX.ctx = (mesh, _table(mesh, rules, overrides))
    try:
        if prev is None:
            # (the context manager is not re-entrant: the outermost only)
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.ctx = prev


def _table(mesh: Any, rules: Optional[Dict[str, Any]],
           overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    table = dict(DEFAULT_RULES if rules is None else rules)
    if overrides:
        table.update(overrides)
    # drop mesh axes that don't exist (e.g. "pod" on the single-pod mesh)
    names = set(mesh.mesh_dim_names)

    def resolve(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            kept = tuple(a for a in v if a in names)
            return kept if kept else None
        return v if v in names else None

    return {k: resolve(v) for k, v in table.items()}


def logical_to_spec(axes: Sequence[Logical],
                    table: Optional[Dict[str, Any]] = None) -> Spec:
    """Map logical axis names to a spec tuple using the active rules. A
    mesh axis already used by an earlier dimension is not used again."""
    if table is None:
        ctx = _current()
        if ctx is None:
            return ()
        table = ctx[1]
    spec = []
    used: set = set()

    def lookup(name):
        if name is None:
            return None
        v = table.get(name, None)
        return v

    for ax in axes:
        if isinstance(ax, tuple):
            parts = []
            for a in ax:
                v = lookup(a)
                if v is None:
                    continue
                parts.extend(v if isinstance(v, tuple) else (v,))
            parts = [p for p in parts if p not in used]
            used.update(parts)
            spec.append(tuple(parts) if parts else None)
        else:
            v = lookup(ax)
            if isinstance(v, tuple):
                v = tuple(p for p in v if p not in used)
                used.update(v)
                spec.append(v if v else None)
            else:
                if v in used:
                    v = None
                if v is not None:
                    used.add(v)
                spec.append(v)
    # one mesh axis stands bare, as a PartitionSpec entry normalizes it
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def placements_for(spec: Spec, mesh: Any) -> Tuple[Any, ...]:
    """One placement per mesh dimension: ``Shard(d)`` for the tensor
    dimension ``d`` whose spec entry names that mesh axis, else
    ``Replicate()``. A dimension that takes several axes (``("pod",
    "data")``) is sharded over each of them, in mesh order (the first mesh
    axis the outer one, as in the reference). A mesh axis of one rank
    replicates: a shard of all of a tensor is the tensor."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            where[name] = d
    return tuple(Shard(where[name]) if name in where and mesh.size(i) > 1
                 else Replicate()
                 for i, name in enumerate(mesh.mesh_dim_names))


def axis_size(*axes: Logical) -> int:
    """How many ways the active rules split a dimension named ``axes``
    (1 without a mesh): the product of the sizes of its mesh axes."""
    ctx = _current()
    if ctx is None:
        return 1
    mesh, table = ctx
    spec = logical_to_spec(axes, table)
    n = 1
    for entry in spec:
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                n *= mesh.size(mesh.mesh_dim_names.index(name))
    return n


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *axes: Logical) -> torch.Tensor:
    """``redistribute`` by logical names; a no-op without a mesh or on a
    plain tensor."""
    ctx = _current()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, table = ctx
    placements = placements_for(logical_to_spec(axes, table), mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums reduced (``Partial`` → ``Replicate``, an
    all-reduce), its shards kept; anything else as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def named_sharding(axes: Sequence[Logical]) -> Optional[Tuple[Any, tuple]]:
    """``(mesh, placements)`` for ``axes`` under the active rules, or
    None without a mesh."""
    ctx = _current()
    if ctx is None:
        return None
    mesh, table = ctx
    return mesh, placements_for(logical_to_spec(axes, table), mesh)


def _shardings(spec_tree: Any, mesh: Any, table: Dict[str, Any]) -> Any:
    return tree_map(lambda axes: (mesh, placements_for(
        logical_to_spec(axes or (), table), mesh)), spec_tree)


def specs_to_shardings(spec_tree: Any, mesh: Any,
                       rules: Optional[Dict[str, Any]] = None,
                       overrides: Optional[Dict[str, Any]] = None) -> Any:
    """A tree of logical-axis tuples → a tree of ``(mesh, placements)``."""
    return _shardings(spec_tree, mesh, _table(mesh, rules, overrides))


def place(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` as a DTensor placed by the matching
    ``(mesh, placements)`` of ``shardings``: a DTensor redistributed, a
    tensor scattered from rank 0's copy (``distribute_tensor``), a meta
    tensor (the dry run's) given its local shape without data."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def put(x, sharding):
        mesh, placements = sharding
        if is_dtensor(x):
            return x.redistribute(mesh, placements)
        if x.device.type == "meta":
            shape, _ = compute_local_shape_and_global_offset(
                x.shape, mesh, placements)
            local = torch.empty(shape, dtype=x.dtype, device="meta")
            return DTensor.from_local(local, mesh, placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())
        return distribute_tensor(x, mesh, placements)

    return tree_map(put, tree, shardings)


def place_by_specs(tree: Any, spec_tree: Any) -> Any:
    """``tree`` placed by the logical ``spec_tree`` under the active rules
    (``place``); as it is without a mesh."""
    ctx = _current()
    if ctx is None:
        return tree
    return place(tree, _shardings(spec_tree, *ctx))

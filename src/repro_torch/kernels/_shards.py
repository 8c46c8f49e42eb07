"""The kernels under a mesh: each wrapper runs on each rank's local shard.

A wrapper passes ``data_ptr()``s to the kernel library, so a DTensor
cannot reach it. Where an input is a DTensor, the wrapper takes each
input's local shard (``to_local``), runs its own plain-tensor path on
the shards (the kernel, or its ``autograd.Function``, on the card; the
plain version on the CPU, and on the meta shards of the dry run, which
counts a program from its shapes as the reference's forces its XLA
attention), and wraps the result back
with the placements it follows (``from_local``). Both carry the gradient.
A placement the kernel cannot take, such as a sharded sequence or
head_dim, or a ``Partial`` input, raises: there is no quiet fall back to
the plain version.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Set

import torch


def any_dtensor(*tensors: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in tensors)


def on_meta(t: Any) -> bool:
    """Whether DTensor ``t``'s shards are meta tensors (shapes only)."""
    return t._local_tensor.device.type == "meta"


def check(name: str, what: str, t: Any, shardable: Iterable[int]) -> None:
    """Raise unless every placement of DTensor ``t`` is ``Replicate`` or a
    ``Shard`` of one of the tensor dims ``shardable``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return
    ok = set(shardable)
    for i, p in enumerate(t.placements):
        if p.is_replicate():
            continue
        if p.is_shard() and p.dim in ok:
            continue
        raise ValueError(
            f"{name}: {what} placed {tuple(t.placements)} on mesh "
            f"{t.device_mesh.mesh_dim_names}: the kernel takes shards of "
            f"dims {sorted(ok)} only (mesh dim {i} is {p})")


def same(name: str, what: str, a: Any, b: Any,
         dims: Dict[int, int]) -> None:
    """Raise unless DTensor ``b`` is placed as ``a`` with each of ``a``'s
    sharded dims ``d`` at ``dims[d]`` of ``b`` (unsharded dims of ``a``
    replicated in ``b``); a plain ``b`` is taken as replicated, as it is
    under ``use_sharding``."""
    from torch.distributed.tensor import DTensor
    pa = tuple(a.placements)
    if not isinstance(b, DTensor):
        if any(p.is_shard() and p.dim in dims for p in pa):
            raise ValueError(f"{name}: {what} is a plain tensor beside a "
                             f"DTensor placed {pa}")
        return
    if b.device_mesh != a.device_mesh:
        raise ValueError(f"{name}: {what} is on another mesh")
    for i, (p, q) in enumerate(zip(pa, b.placements)):
        want = p.is_shard() and p.dim in dims
        if want and not (q.is_shard() and q.dim == dims[p.dim]):
            raise ValueError(f"{name}: {what} must be sharded on dim "
                             f"{dims[p.dim]} over mesh dim {i}, as its "
                             f"partner is; it is {q}")
        if not want and not q.is_replicate():
            raise ValueError(f"{name}: {what} must be replicated over mesh "
                             f"dim {i}; it is {q}")


def divides(name: str, t: Any, dim: int, sizes: Sequence[int]) -> None:
    """Raise unless every length in ``sizes`` splits evenly over the mesh
    dims that shard ``t``'s dim ``dim`` (whole groups a rank)."""
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_shard() and p.dim == dim:
            n *= t.device_mesh.size(i)
    for s in sizes:
        if s % n:
            raise ValueError(f"{name}: {s} does not split evenly over the "
                             f"{n} ranks that shard dim {dim}")


def split_dims(*tensors: Any) -> Set[int]:
    """The mesh dims over which any of ``tensors`` is sharded: the work of
    the call is divided over those."""
    from torch.distributed.tensor import DTensor
    out: Set[int] = set()
    for t in tensors:
        if isinstance(t, DTensor):
            out.update(i for i, p in enumerate(t.placements) if p.is_shard())
    return out


def local(t: Any, split: Set[int]) -> Optional[torch.Tensor]:
    """``t``'s local shard. A replicated input of a call whose work is
    split over mesh dim ``i`` gets a gradient that is a partial sum over
    ``i`` (each rank's share of it)."""
    from torch.distributed.tensor import DTensor, Partial
    if not isinstance(t, DTensor):
        return t
    grad = tuple(Partial() if p.is_replicate() and i in split else p
                 for i, p in enumerate(t.placements))
    return t.to_local(grad_placements=grad)


def wrap(out: torch.Tensor, like: Any, shape: Sequence[int],
         placements: Optional[Sequence[Any]] = None) -> Any:
    """``out``, one rank's shard of a tensor of global ``shape``, as a
    DTensor on ``like``'s mesh with ``placements`` (default ``like``'s)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = []
    acc = 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    # the DTensor's strides are the contiguous ones; so must the shard's be
    return DTensor.from_local(
        out.contiguous(), like.device_mesh,
        tuple(like.placements if placements is None else placements),
        run_check=False, shape=shape, stride=tuple(reversed(stride)))


def remap(like: Any, dims: Dict[int, int]) -> tuple:
    """``like``'s placements with each ``Shard(d)`` moved to
    ``Shard(dims[d])`` (a dim not in ``dims`` raises)."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(dims[p.dim]) if p.is_shard() else p
                 for p in like.placements)

"""Production mesh construction (counterpart of ``repro/launch/mesh.py``).

FUNCTIONS, not module-level constants: importing this module touches no
CUDA state and starts no process group. Each function builds a
``DeviceMesh`` over the process group the caller has initialised (the dry
run's fake 256/512-rank group, or a real launch's).

The single-pod mesh is 256 cards as ``(data, model) = (32, 8)``; the
multi-pod mesh adds the scale-out "pod" axis: ``(pod, data, model) = (2,
16, 8)``, 512 cards. The pod axis composes with data for batch/FSDP
sharding (logical rules in ``repro_torch.sharding``), so the multi-pod dry
run proves cross-pod gradient reduction shards.

Why not the reference's 16×16: on a TPU pod every chip reaches its
neighbours over the same ICI links, so a square mesh is as good as any.
An H100 reaches only the 7 other cards of its host over NVLink (450 GB/s
each way); everything else crosses the network, at about a ninth of that
(``roofline.counts``). The tensor-parallel "model" axis, whose
collectives run every layer, is therefore one 8-card host, and data and
pod span hosts.
"""
from __future__ import annotations

#: the NVLink domain: cards in one host
HOST_CARDS = 8


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, HOST_CARDS) if multi_pod else (32, HOST_CARDS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False, device_type: str = "cuda"):
    """Small mesh for CI-scale dry-run tests (4 or 8 ranks)."""
    shape = (2, n_data, n_model) if multi_pod else (n_data, n_model)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)

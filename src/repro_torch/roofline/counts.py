"""Operation, byte and collective counts of a program, and roofline terms
against the H100's peaks.

Counterpart of ``repro/roofline/hlo.py``, which reads them from a compiled
XLA module. Here a program runs on meta tensors (shapes, no values) under
``CountMode``, usually on meta DTensors over a fake process group of 256
or 512 ranks (``launch.dryrun``), and the mode counts one device's share:

* **FLOPs** by ``torch.utils.flop_counter``'s formulas, applied to each
  op's *local* shard shapes. The mode lets DTensor dispatch an op first
  and sees the local ops it runs on each rank's shard; counting at the
  DTensor level would count the global product.
* **bytes accessed**: each local op's tensor inputs read once and its
  fresh outputs written once; views move nothing.
* **collective operand bytes and counts** by the reference's five kinds
  and by mesh axis, from the ``_c10d_functional`` ops DTensor issues (the
  per-device payload, as the reference's parse counts it).
* **live intermediates**: the bytes of op outputs alive at once, and
  their peak (the dry run's counterpart of XLA's temp size). Bare
  allocations (``empty``) are not counted: they write nothing, and
  DTensor's sharding propagation makes global-shape ones of its own.

``roofline_terms`` turns them into seconds at the H100 SXM's dense peaks:
989 TFLOP/s bf16, 67 TFLOP/s fp32, 3.35 TB/s of HBM; a collective's
bytes over NVLink at 450 GB/s each way for the model axis (one 8-card
host), and at 50 GB/s a card for the data and pod axes. **That last
figure is an assumption**: one 400 Gb/s NDR port a GPU between hosts, as
on a DGX H100; a cluster with other networking moves it. Ring algorithms
move about (n−1)/n of a payload per link, which this model rounds to 1,
as the reference's does.
"""
from __future__ import annotations

import collections
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry as _FLOP_FORMULAS

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BF16 = PEAK_FLOPS[torch.bfloat16]
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way, within one 8-card host
NET_BW = 50e9                # bytes/s a card between hosts (assumed)
#: the link each mesh axis crosses
AXIS_BW = {"model": NVLINK_BW, "data": NET_BW, "pod": NET_BW}

#: ops that return a view though their schema does not say so
_VIEWS = ("_unsafe_view",)
#: allocations that write nothing (see the module's docstring)
_BARE = ("empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: op-name fragments → collective kind (functional and in-place c10d ops)
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("send", "collective-permute"), ("recv", "collective-permute"),
          ("broadcast", "collective-permute"))


_COMM_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")


def _collective_kind(func) -> Optional[str]:
    name = func._opname
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class CountMode(TorchDispatchMode):
    """Counts the local ops a program runs (see the module's docstring).
    ``mesh``, when given, names each collective's mesh axis."""

    def __init__(self, mesh: Any = None):
        super().__init__()
        self.flops: Dict[str, float] = collections.Counter()
        self.bytes = 0.0
        self.ops: Dict[str, Dict[str, float]] = {}
        self.collectives = {k: {"count": 0, "bytes": 0.0}
                            for k in COLLECTIVES}
        self.by_axis: Dict[str, float] = collections.Counter()
        self.live = 0
        self.peak = 0
        self._axis: Dict[str, str] = {}
        if mesh is not None:
            for name in mesh.mesh_dim_names:
                self._axis[mesh.get_group(name).group_name] = name

    # ------------------------------------------------------------ helpers
    def _release(self, n: int) -> None:
        self.live -= n

    def _hold(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, n)

    def _axis_of(self, args, kwargs) -> str:
        names = [a for a in list(args) + list(kwargs.values())
                 if isinstance(a, str)]
        for name in reversed(names):
            if name in self._axis:
                return self._axis[name]
        return "?"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs the local ops
        if func is torch.ops.aten.equal.default and all(
                t.device.type == "meta" for t in _tensors(args)):
            # meta tensors carry no values (DTensor compares two masks of
            # a sharded lookup): equal when their shapes are
            return args[0].shape == args[1].shape
        out = func(*args, **kwargs)
        if types or func._opname in _BARE:  # fake tensors, allocations
            return out
        if func.namespace in _COMM_NAMESPACES:
            # a collective's operand, once; waits and wrappers move nothing
            kind = _collective_kind(func)
            first = next(_tensors(args), None)
            if kind is not None and first is not None:
                n = float(_nbytes(first))
                self.collectives[kind]["count"] += 1
                self.collectives[kind]["bytes"] += n
                self.by_axis[self._axis_of(args, kwargs)] += n
                for o in _tensors(out):
                    self._hold(o)
            return out
        schema = func._schema
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        alias = [r.alias_info is not None for r in schema.returns]
        if func._opname in _VIEWS or (outs and alias and all(alias) and not any(
                r.alias_info.is_write for r in schema.returns)):
            return out                      # a view: no data moves
        packet = func._overloadpacket
        flops = 0.0
        if packet in _FLOP_FORMULAS:
            flops = float(_FLOP_FORMULAS[packet](*args, **kwargs,
                                                 out_val=out))
            dtype = next((t.dtype for t in ins if t.is_floating_point()),
                         torch.float32)
            self.flops[str(dtype).replace("torch.", "")] += flops
        moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += moved
        rec = self.ops.setdefault(packet.__name__, {"count": 0,
                                                    "out_bytes": 0.0})
        rec["count"] += 1
        rec["out_bytes"] += float(sum(_nbytes(t) for t in outs))
        fresh = [o for o, a in zip(outs, alias + [False] * len(outs))
                 if not a]
        for o in fresh:
            self._hold(o)
        return out

    # ------------------------------------------------------------ results
    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def compute_seconds(self) -> float:
        return sum(n / PEAK_FLOPS.get(getattr(torch, k), PEAK_BF16)
                   for k, n in self.flops.items())

    def collective_seconds(self) -> float:
        return sum(n / AXIS_BW.get(axis, NET_BW)
                   for axis, n in self.by_axis.items())

    def op_bytes_histogram(self, top: int = 14) -> Dict[str, Dict]:
        """Output bytes and op counts per op — the counterpart of the
        reference's ``opcode_bytes_histogram``."""
        ranked = sorted(self.ops.items(), key=lambda kv: -kv[1]["out_bytes"])
        return dict(ranked[:top])


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, chips: int, *,
                   compute_s: Optional[float] = None,
                   collective_s: Optional[float] = None
                   ) -> Dict[str, Any]:
    """The reference's terms at the H100's peaks. ``compute_s`` and
    ``collective_s`` default to the FLOPs at the bf16 peak and the bytes
    at the network's 50 GB/s; ``CountMode`` gives both by dtype and by
    mesh axis."""
    if compute_s is None:
        compute_s = flops_per_device / PEAK_BF16
    if collective_s is None:
        collective_s = coll_bytes_per_device / NET_BW
    memory_s = bytes_per_device / HBM_BW
    terms: Dict[str, Any] = {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "flops_global": flops_per_device * chips,
        "bytes_global": bytes_per_device * chips,
        "coll_bytes_global": coll_bytes_per_device * chips}
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["dominant"] = dom
    bound = max(compute_s, memory_s, collective_s)
    terms["roofline_fraction"] = (compute_s / bound) if bound else 0.0
    return terms


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """6·N·D (train) / 2·N_active·D (inference fwd) per assignment."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens

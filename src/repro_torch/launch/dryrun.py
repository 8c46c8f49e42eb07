"""Multi-pod dry run: build and count every (architecture × shape × mesh).

Counterpart of ``repro/launch/dryrun.py``. For each cell it:

  1. starts a fake process group of the mesh's size (``backend="fake"``,
     one process standing for rank 0 of 256 or 512) and builds the
     production mesh (32×8 single-pod / 2×16×8 multi-pod, ``launch.mesh``)
     or the debug mesh (2×2 / 2×2×2);
  2. builds the step program (train step / prefill step / dense decode
     step) on meta tensors — shapes and dtypes, no storage — placed as
     DTensors by the logical rules (``train.sharding.rules_for``);
  3. runs it under ``roofline.counts.CountMode``. A placement the program
     cannot take raises here: that raise is the counterpart of a failed
     ``.compile()`` in the reference;
  4. dumps ``memory`` / ``cost`` / ``collectives`` / ``op_hist`` /
     ``roofline`` as JSON, in the reference's keys, so that
     ``roofline.report`` reads the results of both.

``memory`` is one device's share: the argument and output bytes of the
local shards, and the peak bytes of live intermediates the counting mode
saw (``temp_bytes_per_device``). ``alias_bytes_per_device`` counts the
outputs that are argument buffers written in place (the decode steps'
cache); the train step is out of place (a new state, AdamW never writes
its inputs), so its alias bytes are 0. ``fits_80g_hbm`` is arguments +
outputs + temporaries − aliases below 80e9, as the reference's 16 GB check.

Accounting modes:
  * ``--exact``: a single-microbatch train program; totals scale by the
    microbatch count (the reference's roofline mode).
  * default: the whole microbatched program. The port always runs its
    layers as a Python loop (there is no scan to unroll), so both modes
    count every layer.

The kernels run their plain versions on meta tensors, as the reference's
dry run forces ``attn_impl="xla"``: attention is counted as the plain
version's products and softmax.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import sys
import time
import warnings
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import (make_debug_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.shapes import (SHAPES, WHISPER_CROSS_LEN, ShapeSpec,
                                       input_specs, is_applicable,
                                       microbatches_for)
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec, lm
from repro_torch.models.common import AUDIO, ModelConfig
from repro_torch.optim import OptConfig
from repro_torch.roofline.counts import CountMode, model_flops, roofline_terms
from repro_torch.sharding import (axis_size, place, specs_to_shardings,
                                  use_sharding)
from repro_torch.train.sharding import batch_logical_axes, rules_for
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          train_state_specs)


def fake_world(size: int) -> None:
    """Start (once per process) a fake process group of ``size`` ranks,
    this process its rank 0: collectives return at once, on meta tensors
    they move nothing."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks is running, not {size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def serve_state_specs(cfg: ModelConfig) -> Any:
    if cfg.family == AUDIO:
        cross = {"k": (None, "batch", None, None, "tp"),
                 "v": (None, "batch", None, None, "tp")}
        return {"cross": cross,
                "self": attn_mod.kv_cache_specs(True, cfg)}
    return lm.cache_specs(cfg)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _serve_state(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    """The decode state's meta tensors (no encoder pass for whisper: its
    cross-KV has the canonical 1500 encoder positions)."""
    if cfg.family == AUDIO:
        L, KV, hd = (cfg.n_dec_layers, cfg.padded_kv_heads,
                     cfg.resolved_head_dim)
        cross = _meta((L, batch, WHISPER_CROSS_LEN, KV, hd), cfg.dtype)
        return {"cross": {"k": cross, "v": cross.clone()},
                "self": attn_mod.init_kv_cache(cfg, batch, max_len,
                                               n_layers=L, device="meta")}
    return lm.init_cache(cfg, batch, max_len, device="meta")


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_bytes(leaves) -> int:
    """Bytes of one device's shards of ``leaves``."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in leaves:
        t = t._local_tensor if isinstance(t, DTensor) else t
        n += t.numel() * t.element_size()
    return n


def build_program(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                  exact: bool, opts: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Returns {fn, args, n_repeat, tokens} for the cell: ``fn(*args)`` is
    the step on placed meta DTensors."""
    opts = opts or {}
    rules = rules_for(shape.kind)
    batch = input_specs(cfg, shape)

    def placed(tree, specs):
        return place(tree, specs_to_shardings(specs, mesh, rules))

    if shape.kind == "train":
        state_dtype = torch.bfloat16 if (
            opts.get("opt_dtype") == "bf16"
            or (opts.get("opt_dtype") is None
                and cfg.param_count() > 2e11)) else torch.float32
        opt = OptConfig(state_dtype=state_dtype)
        n_mb = opts.get("microbatches") or microbatches_for(cfg)
        # each microbatch must split evenly over the batch ranks (DTensor
        # flattens no unevenly sharded batch): 32 data ranks here, where
        # the reference's mesh has 16, cap llama3's and command-r's 16
        ranks = axis_size("batch")
        while n_mb > 1 and (shape.global_batch % n_mb
                            or (shape.global_batch // n_mb) % ranks):
            n_mb -= 1
        n_repeat = 1
        if exact:
            # single-microbatch exact program; totals scale ×n_mb
            sub = ShapeSpec(shape.name, "train", shape.seq_len,
                            shape.global_batch // n_mb)
            batch = input_specs(cfg, sub)
            n_repeat, n_mb = n_mb, 1
        gst = train_state_specs(cfg)["params"] if opts.get("grad_rs") \
            else None
        step = make_train_step(cfg, opt, num_microbatches=n_mb,
                               grad_spec_tree=gst)
        state = placed(init_train_state(cfg, opt, device="meta"),
                       train_state_specs(cfg))
        batch = placed(batch, batch_logical_axes(batch))
        return {"fn": step, "args": (state, batch), "n_repeat": n_repeat,
                "tokens": shape.global_batch * shape.seq_len,
                "microbatches": max(n_mb, n_repeat)}

    init = encdec.init_params if cfg.family == AUDIO else lm.init_params
    pspecs = (encdec.param_specs if cfg.family == AUDIO
              else lm.param_specs)(cfg)
    params = placed(init(cfg, device="meta"), pspecs)

    if shape.kind == "prefill":
        from repro_torch.serve.steps import make_prefill_step
        step = make_prefill_step(cfg, shape.seq_len)
        batch = placed(batch, batch_logical_axes(batch))
        return {"fn": step, "args": (params, batch), "n_repeat": 1,
                "tokens": shape.global_batch * shape.seq_len}

    # decode / long: one token against a seq_len cache, at its last slot
    from repro_torch.serve.steps import make_decode_step
    B = shape.global_batch
    cache = placed(_serve_state(cfg, B, shape.seq_len),
                   serve_state_specs(cfg))
    token = placed({"t": _meta((B, 1), torch.int32)},
                   {"t": ("batch", None)})["t"]
    step = make_decode_step(cfg)
    return {"fn": step, "args": (params, cache, token, shape.seq_len - 1),
            "n_repeat": 1, "tokens": B}


def count_program(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                  exact: bool = True,
                  opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build and run one cell's program under ``CountMode`` on ``mesh``;
    the result's ``memory``, ``cost``, ``collectives``, ``op_hist`` and
    ``roofline`` in the reference's keys."""
    result: Dict[str, Any] = {}
    t0 = time.time()
    rules = rules_for(shape.kind)
    with use_sharding(mesh, rules):
        prog = build_program(cfg, shape, mesh, exact=exact, opts=opts)
        result["lower_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        mode = CountMode(mesh)
        with mode:
            out = prog["fn"](*prog["args"])
        result["compile_s"] = round(time.time() - t0, 2)
    args = list(_leaves(prog["args"]))
    outs = list(_leaves(out))
    arg_ids = {id(t) for t in args}
    arg_b, out_b = _local_bytes(args), _local_bytes(outs)
    alias_b = _local_bytes(t for t in outs if id(t) in arg_ids)
    result["memory"] = {
        "argument_bytes_per_device": int(arg_b),
        "output_bytes_per_device": int(out_b),
        "temp_bytes_per_device": int(mode.peak),
        "alias_bytes_per_device": int(alias_b),
        "fits_80g_hbm": bool(arg_b + out_b + mode.peak - alias_b < 80e9),
    }
    n_rep = prog["n_repeat"]
    flops_dev = mode.total_flops * n_rep
    bytes_dev = mode.bytes * n_rep
    colls = {k: {"count": v["count"] * n_rep, "bytes": v["bytes"] * n_rep}
             for k, v in mode.collectives.items()}
    coll_dev = sum(v["bytes"] for v in colls.values())
    result["op_hist"] = mode.op_bytes_histogram()
    result["collectives"] = colls
    result["collective_bytes_by_axis"] = {
        k: v * n_rep for k, v in mode.by_axis.items()}
    result["cost"] = {"flops_per_device": flops_dev,
                      "flops_per_device_by_dtype": {
                          k: v * n_rep for k, v in mode.flops.items()},
                      "bytes_per_device": bytes_dev,
                      "collective_bytes_per_device": coll_dev,
                      "n_repeat_scaling": n_rep}
    chips = mesh.size() if mesh is not None else 1
    terms = roofline_terms(flops_dev, bytes_dev, coll_dev, chips,
                           compute_s=mode.compute_seconds() * n_rep,
                           collective_s=mode.collective_seconds() * n_rep)
    mf = model_flops(cfg, shape.kind, prog["tokens"])
    terms["model_flops"] = mf
    terms["useful_flops_ratio"] = mf / terms["flops_global"] \
        if terms["flops_global"] else 0.0
    result["roofline"] = terms
    result["chips"] = chips
    if "microbatches" in prog:
        result["microbatches"] = prog["microbatches"]
    return result


def config_for(arch: str, opts: Dict[str, Any]) -> ModelConfig:
    overrides: Dict[str, Any] = {}
    for key, field in (("remat", "remat"), ("n_layers", "n_layers")):
        if opts.get(key):
            overrides[field] = opts[key]
    if opts.get("lean"):
        overrides["lean_attention"] = True
    if opts.get("gather_weights"):
        overrides["gather_weights"] = True
    if opts.get("dtype"):
        dt = getattr(torch, opts["dtype"])
        overrides.update(dtype=dt, param_dtype=dt)
    cfg = get_config(arch, **overrides)
    if opts.get("dispatch") and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=opts["dispatch"]))
    if opts.get("ssm_chunk") and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm,
                                         chunk_size=opts["ssm_chunk"]))
    return cfg


def mesh_for(*, multi_pod: bool, debug_mesh: bool,
             shape: Optional[tuple] = None):
    """The cell's mesh on a fake process group of its size. Its device
    type is "cuda" (no card is touched: the group moves nothing), so that
    DTensor issues each collective as it would on the cards (on a CPU
    mesh it turns an all-to-all into an all-gather)."""
    if shape is not None:
        fake_world(math.prod(shape))
        axes = ("pod", "data", "model")[-len(shape):]
        return make_mesh(shape, axes, "cuda")
    n = (8 if multi_pod else 4) if debug_mesh else (512 if multi_pod
                                                    else 256)
    fake_world(n)
    make = make_debug_mesh if debug_mesh else make_production_mesh
    return make(multi_pod=multi_pod, device_type="cuda")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, exact: bool,
             debug_mesh: bool = False,
             opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    opts = opts or {}
    shape = SHAPES[shape_name]
    if opts.get("batch") or opts.get("seq_len"):
        shape = ShapeSpec(shape.name, shape.kind,
                          opts.get("seq_len") or shape.seq_len,
                          opts.get("batch") or shape.global_batch)
    cfg = config_for(arch, opts)
    ok, reason = is_applicable(cfg, shape)
    result: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape_name, "multi_pod": multi_pod,
        "exact": exact, "applicable": ok, "reason": reason,
    }
    if not ok:
        result["status"] = "skipped"
        return result
    mesh = mesh_for(multi_pod=multi_pod, debug_mesh=debug_mesh,
                    shape=opts.get("mesh"))
    result["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    result["opts"] = {k: v for k, v in opts.items() if v}
    result.update(count_program(cfg, shape, mesh, exact=exact, opts=opts))
    result["status"] = "ok"
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--exact", action="store_true",
                    help="single-microbatch train program (roofline mode)")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="tiny 2x2 mesh (CI tests)")
    ap.add_argument("--mesh", default=None,
                    help="another mesh shape, e.g. 1x1 or 4x2 "
                         "((data, model), or (pod, data, model))")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="sequence (cache) length in place of the shape's")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default=None, help="activation and parameter dtype")
    ap.add_argument("--out", default=None)
    # hillclimb levers (§Perf)
    ap.add_argument("--remat", choices=["none", "full", "dots"], default=None)
    ap.add_argument("--dispatch", choices=["einsum", "scatter"], default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--opt-dtype", choices=["f32", "bf16"], default=None)
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--grad-rs", action="store_true",
                    help="constrain grads to weight sharding (reduce-scatter)")
    ap.add_argument("--lean", action="store_true",
                    help="memory-lean attention/rope (bf16 tensors, fp32 "
                         "reductions)")
    ap.add_argument("--gather-weights", action="store_true",
                    help="ZeRO-3 just-in-time weight all-gather (§Perf)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="layer-count override")
    args = ap.parse_args()
    mesh = tuple(int(s) for s in args.mesh.split("x")) if args.mesh \
        else None
    opts = {"remat": args.remat, "dispatch": args.dispatch,
            "microbatches": args.microbatches, "opt_dtype": args.opt_dtype,
            "ssm_chunk": args.ssm_chunk, "grad_rs": args.grad_rs,
            "lean": args.lean, "gather_weights": args.gather_weights,
            "n_layers": args.n_layers, "mesh": mesh, "batch": args.batch,
            "seq_len": args.seq_len, "dtype": args.dtype}
    # DTensor's notes on its redistribution choices are not results
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    warnings.filterwarnings("ignore")
    result = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                      exact=args.exact, debug_mesh=args.debug_mesh,
                      opts=opts)
    js = json.dumps(result, indent=2, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    print(js)
    if result["status"] not in ("ok", "skipped"):
        sys.exit(1)


if __name__ == "__main__":
    main()

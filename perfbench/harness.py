"""The run of one cell: the device, the program's configuration as the
file states it, the module of the cell's path (``serve_cell`` or
``train_cell``), and the result line's object."""
from __future__ import annotations

import sys
from typing import Any, Dict, Mapping

import torch

from perfbench import spec

#: the types a configuration file may state
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def device_for(chips: int, check: bool = True) -> torch.device:
    """The card the run uses. Without CUDA, or with fewer cards than the
    cell asks for, the run stops here: it never falls back to the CPU
    (``check=False`` is the CPU tests' way past this look)."""
    if not check:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card "
                         "and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def model_sizes(cfg: Any) -> Dict[str, Any]:
    """The sizes of a ``repro_torch`` configuration, keyed as a
    configuration file's ``model`` section."""
    s = cfg.ssm
    return {"family": cfg.family, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab_size": cfg.vocab_size,
            "padded_vocab": cfg.padded_vocab, "norm_eps": cfg.norm_eps,
            "ssm": {"state_dim": s.state_dim, "head_dim": s.head_dim,
                    "expand": s.expand, "conv_width": s.conv_width,
                    "n_groups": s.n_groups, "chunk_size": s.chunk_size},
            "hybrid_attn_every": cfg.hybrid_attn_every,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "rope_theta": cfg.rope_theta}


def program_config(conf: Mapping[str, Any], path: str) -> Any:
    """The ``repro_torch`` configuration the file names, in the type its
    ``path`` section states; refused where a size differs from the
    file's."""
    from repro_torch.configs import get_config
    prog = conf["program"]
    dt = DTYPES[conf[path]["dtype"]]
    kw = dict(prog.get("overrides", {}))
    if path == "train":
        kw["remat"] = conf["train"]["remat"]
    cfg = get_config(prog["name"], reduced=bool(prog.get("reduced")),
                     dtype=dt, param_dtype=dt, **kw)
    have = model_sizes(cfg)
    for key, want in conf["model"].items():
        if key in have and have[key] != want:
            raise SystemExit(f"configuration {conf['name']}: the program's "
                             f"{key} is {have[key]!r}, the file says "
                             f"{want!r}")
    return cfg


def run_cell(bench: Mapping[str, Any], cell: Mapping[str, Any],
             conf: Mapping[str, Any], seed: int, seconds: float,
             trace: bool, device: torch.device,
             t_start: float) -> Dict[str, Any]:
    """One run: the cell's path, then the metrics the cell reports."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = cell["path"]
    cfg = program_config(conf, path)
    if path == "serve":
        from perfbench import serve_cell as path_mod
    elif path == "train":
        from perfbench import train_cell as path_mod
    else:
        raise SystemExit(f"cell {cell['name']}: unknown path {path!r}")
    out = path_mod.run(cell, conf, cfg, seed, seconds, trace, device,
                       t_start)
    run = out["run"]
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        values = run.end_to_end()
        for m in spec.end_to_end(bench, cell["name"]):
            value = out["setup_s"] if m["name"] == "setup_s" \
                else values.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.per_layer(bench, cell["name"]):
            value = spec.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev: Dict[str, Any] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": out["peak"]}
    result: Dict[str, Any] = {
        "correct": out["correct"], "attempted": out["attempted"],
        "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace and run.timeline is not None:
        tl = run.timeline
        dev["busy_s"] = tl.busy_s
        dev["window_s"] = tl.window_s
        result["breakdown"] = {"device_ops": tl.top_ops(),
                               "idle_gaps": tl.idle_gaps()}
        print(f"profiled slice: {tl.wall_s:.3f} s; the profiler took "
              f"{tl.start_s:.3f} s to start", file=sys.stderr)
    if "sampled_tokens" in out:
        print(f"served tokens compared: {out['sampled_tokens']}",
              file=sys.stderr)
    result["checks"] = out["checks"]
    return result

"""Dry-run sweep: every (architecture × shape) cell, both meshes
(counterpart of ``repro/launch/sweep.py``).

Each cell runs in a fresh subprocess (a process holds one fake process
group, of one size). Two passes per cell:
  * single-pod (32×8), ``--exact``       → roofline numbers
  * multi-pod (2×16×8), whole program    → proves the pod axis shards

Results accumulate as JSON under ``results/dryrun_torch/`` so the tables
(``roofline.report``) can be regenerated at any time. Cells ordered
smallest-first. Every number is a count from shapes at the H100's peaks,
not a measurement.

    PYTHONPATH=src python -m repro_torch.launch.sweep --skip-multi
    PYTHONPATH=src python -m repro_torch.roofline.report
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ORDER = [
    "mamba2_370m", "zamba2_1p2b", "h2o_danube3_4b", "whisper_large_v3",
    "llama4_scout_17b_16e", "internvl2_26b", "deepseek_coder_33b",
    "qwen3_moe_235b_a22b", "command_r_plus_104b", "llama3_405b",
]
SHAPES = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]


def run_cell(arch: str, shape: str, out_dir: str, *, multi_pod: bool,
             exact: bool, timeout: int, force: bool = False,
             extra_env: dict | None = None) -> dict:
    tag = f"{arch}.{shape}.{'multi' if multi_pod else 'single'}" \
          f"{'.exact' if exact else ''}"
    out = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out) and not force:
        with open(out) as f:
            return json.load(f)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    if exact:
        cmd.append("--exact")
    env = dict(os.environ)
    env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
    if extra_env:
        env.update(extra_env)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
               "exact": exact, "status": "timeout", "elapsed": timeout}
        with open(out, "w") as f:
            json.dump(rec, f)
        return rec
    if proc.returncode != 0:
        rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
               "exact": exact, "status": "error",
               "stderr": proc.stderr[-4000:],
               "elapsed": round(time.time() - t0, 1)}
        with open(out, "w") as f:
            json.dump(rec, f, indent=2)
        return rec
    with open(out) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--only-arch", default=None)
    ap.add_argument("--only-shape", default=None)
    ap.add_argument("--skip-multi", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    archs = [args.only_arch] if args.only_arch else ORDER
    shapes = [args.only_shape] if args.only_shape else SHAPES
    t_start = time.time()
    for arch in archs:
        for shape in shapes:
            for multi_pod, exact in ((False, True), (True, False)):
                if multi_pod and args.skip_multi:
                    continue
                t0 = time.time()
                rec = run_cell(arch, shape, args.out_dir,
                               multi_pod=multi_pod, exact=exact,
                               timeout=args.timeout, force=args.force)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec.get("roofline", {})
                    extra = (f" dom={r.get('dominant')} "
                             f"frac={r.get('roofline_fraction', 0):.3f}")
                print(f"[{time.time() - t_start:7.0f}s] {arch:24s} "
                      f"{shape:12s} {'multi' if multi_pod else 'single':6s} "
                      f"{status:8s} ({time.time() - t0:5.1f}s){extra}",
                      flush=True)


if __name__ == "__main__":
    main()

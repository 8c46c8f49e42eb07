"""Readings for the output check's limit, on the card at a cell's own
size: for each seed, a short window of the cell's traffic, then the
widest gap of the program's served tokens and of the control's (the
reference in the next precision below the configuration's, in the
program's place) on the same sampled requests.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--out readings.jsonl]

A serve cell's control is the reference with every weight product in
fp8 (``reference.model``). A train cell's are the reference in TF32 and
the fault "half of the batch left out" planted in the reference, each
held against the fp32 reference as the program's steps are (its window
can be short: set-up makes the checked steps). One process reads every
seed. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path[:0] = [str(_HERE.parent / "src"), str(_HERE.parent)]

from perfbench import harness, serve_cell, spec, train_cell  # noqa: E402
from perfbench.reference.check import widest_gaps  # noqa: E402
from perfbench.reference.train import compare, reference_steps  # noqa: E402


def readings(cell_name: str, seeds, seconds: float, device):
    import numpy as np
    import torch
    bench = spec.benchmark()
    cell = spec.cell(cell_name)
    conf = spec.config(cell["config"], bench)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = harness.program_config(conf, cell["path"])
    if cell["path"] == "train":
        yield from train_readings(cell, conf, cfg, seeds, seconds, device)
        return
    for seed in seeds:
        out = serve_cell.run(cell, conf, cfg, seed, seconds, False, device,
                             time.monotonic())
        gaps = widest_gaps(conf["model"], out["params"],
                           [(np.asarray(q.prompt), q.tokens)
                            for q in out["samples"]], device, control=True)
        row = {"cell": cell_name, "seed": seed,
               "program": gaps["served"], "control": gaps["control"],
               "sampled_tokens": out["sampled_tokens"],
               "tokens_per_s": out["run"].end_to_end()[
                   "decode_tokens_per_s"]}
        del out
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield row


def train_readings(cell, conf, cfg, seeds, seconds, device):
    import torch
    for seed in seeds:
        out = train_cell.run(cell, conf, cfg, seed, seconds, False, device,
                             time.monotonic())
        hyper = train_cell.hyper(out["opt"])
        block = int(cell["check"]["block_rows"])
        row = {"cell": cell["name"], "seed": seed,
               "program": {k: c["value"] for k, c in out["checks"].items()},
               "tokens_per_s": out["run"].end_to_end().get(
                   "train_tokens_per_s")}
        tf = reference_steps(conf["model"], out["params0"], out["batches"],
                             hyper, device, precision="tf32",
                             block_rows=block)
        row["control_tf32"] = compare(tf, out["ref"])
        B = out["batches"][0].shape[0]
        half = reference_steps(conf["model"], out["params0"],
                               out["batches"], hyper, device,
                               rows=range(B // 2), block_rows=block)
        row["fault_half_batch"] = compare(half, out["ref"])
        del out, tf, half
        torch.cuda.empty_cache()
        yield row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = harness.device_for(1)
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(args.workload, seeds, args.seconds, device):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()

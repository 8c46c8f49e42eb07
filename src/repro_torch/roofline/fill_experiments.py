"""Inject generated tables into a markdown file between markers
(counterpart of ``repro/roofline/fill_experiments.py``): the dry-run and
roofline tables and the bottleneck notes of ``roofline.report``, and a
training run's loss table."""
from __future__ import annotations

import argparse
import json
import os
import re

from repro_torch.roofline.report import (bottleneck_notes, dryrun_table,
                                   load_results, roofline_table)


def replace_between(text: str, start: str, end: str, payload: str) -> str:
    pattern = re.compile(re.escape(start) + r".*?" + re.escape(end),
                         re.DOTALL)
    return pattern.sub(start + "\n" + payload + "\n" + end, text)


def e2e_section(path: str) -> str:
    if not os.path.exists(path):
        return "(run in progress)"
    with open(path) as f:
        r = json.load(f)
    rows = r["rows"]
    pick = [row for row in rows if row["step"] % 25 == 0 or
            row["step"] == rows[-1]["step"]]
    lines = ["| step | loss | elapsed |", "|---|---|---|"]
    for row in pick:
        lines.append(f"| {row['step']} | {row['loss']:.4f} "
                     f"| {row['elapsed_s']:.0f}s |")
    lines.append("")
    lines.append(f"Loss {r['first_loss']:.3f} → {r['final_loss']:.3f} over "
                 f"{r['steps']} steps ({r['elapsed_s']}s wall).")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch")
    ap.add_argument("--experiments", default="EXPERIMENTS.md")
    ap.add_argument("--train-json", default="results/train_small.json")
    args = ap.parse_args()
    results = load_results(args.results)
    with open(args.experiments) as f:
        text = f.read()
    text = replace_between(text, "<!-- DRYRUN_TABLE_START -->",
                           "<!-- DRYRUN_TABLE_END -->", dryrun_table(results))
    text = replace_between(text, "<!-- ROOFLINE_TABLE_START -->",
                           "<!-- ROOFLINE_TABLE_END -->",
                           roofline_table(results))
    text = replace_between(text, "<!-- NOTES_START -->", "<!-- NOTES_END -->",
                           bottleneck_notes(results))
    text = replace_between(text, "<!-- E2E_START -->", "<!-- E2E_END -->",
                           e2e_section(args.train_json))
    with open(args.experiments, "w") as f:
        f.write(text)
    print(f"updated {args.experiments} from {len(results)} results")


if __name__ == "__main__":
    main()

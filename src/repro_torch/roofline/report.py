"""Dry-run and roofline tables from the sweep's JSON (counterpart of
``repro/roofline/report.py``).

The tables read the keys both dry runs write, so the reference's results
and the port's (``launch.dryrun``, under ``results/dryrun_torch/``) print
alike. The port's numbers are counts from shapes at the H100's peaks
(``roofline.counts``), not measurements. The fix hints name the card's
remedies."""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional


def load_results(results_dir: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "—"
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.1f}ms"
    return f"{v * 1e6:.0f}µs"


def _fmt_n(v: Optional[float]) -> str:
    if v is None:
        return "—"
    for unit, scale in (("P", 1e15), ("T", 1e12), ("G", 1e9), ("M", 1e6)):
        if abs(v) >= scale:
            return f"{v / scale:.2f}{unit}"
    return f"{v:.0f}"


FIX_HINTS = {
    ("memory_s", "train"): "cut activation traffic: the flash kernel's "
                           "forward and backward (no (S,S) scores in HBM), "
                           "bf16 master/opt state",
    ("memory_s", "decode"): "KV-cache layout (no permuted copies), "
                            "quantized KV, larger per-step batch",
    ("memory_s", "prefill"): "the flash kernel (no (S,S) scores in HBM), "
                             "no remat in the forward",
    ("memory_s", "long"): "state layout; batch>1 to amortize weight reads",
    ("compute_s", "train"): "drop one-hot dispatch FLOPs (MoE) / reduce "
                            "remat recompute; bf16 GEMMs on the tensor "
                            "cores (wgmma)",
    ("compute_s", "prefill"): "flash attention on wgmma tiles",
    ("collective_s", "train"): "reduce-scatter grad sync instead of "
                               "all-reduce (--grad-rs); keep tensor "
                               "parallelism inside one NVLink host",
    ("collective_s", "decode"): "shrink per-layer all-gathers (act_heads "
                                "layout)",
    ("collective_s", "prefill"): "same",
    ("collective_s", "long"): "sequence-parallel state partitioning",
}


def _fits(mem: Dict) -> bool:
    """The reference's 16 GB TPU check, or the port's 80 GB card's."""
    return bool(mem.get("fits_80g_hbm", mem.get("fits_16g_hbm")))


def _mesh(r: Dict) -> str:
    if "mesh" in r:
        return "×".join(str(n) for n in r["mesh"].values())
    return "2×16×16" if r.get("multi_pod") else "16×16"


def roofline_table(results: List[Dict]) -> str:
    rows = [
        "| arch | shape | status | compute | memory | collective | dominant "
        "| roofline frac | MODEL/counted flops | fits 80 GB |",
        "|---|---|---|---|---|---|---|---|---|---|".replace("|---|---|---|---"
                                                             "|---|---|---|---"
                                                             "|---|---|",
                                                             "|---|---|---|---"
                                                             "|---|---|---|---"
                                                             "|---|"),
    ]
    for r in results:
        if r.get("multi_pod") or not r.get("exact"):
            continue
        arch, shape = r["arch"], r["shape"]
        if r["status"] == "skipped":
            rows.append(f"| {arch} | {shape} | skip: {r['reason'][:40]}… "
                        f"| — | — | — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {arch} | {shape} | {r['status']} "
                        f"| — | — | — | — | — | — | — |")
            continue
        t = r["roofline"]
        mem = r["memory"]
        rows.append(
            f"| {arch} | {shape} | ok | {_fmt_s(t['compute_s'])} "
            f"| {_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} "
            f"| {t['dominant'].replace('_s', '')} "
            f"| {t['roofline_fraction']:.3f} "
            f"| {t['useful_flops_ratio']:.2f} "
            f"| {'✓' if _fits(mem) else '✗'} |")
    return "\n".join(rows)


def dryrun_table(results: List[Dict]) -> str:
    rows = [
        "| arch | shape | mesh | status | compile | args/dev | temp/dev "
        "| collectives (count) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        mesh = _mesh(r)
        arch, shape = r["arch"], r["shape"]
        if r["status"] == "skipped":
            rows.append(f"| {arch} | {shape} | {mesh} | skipped (documented) "
                        f"| — | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {arch} | {shape} | {mesh} | {r['status']} "
                        f"| — | — | — | — |")
            continue
        mem = r["memory"]
        colls = r.get("collectives", {})
        cstr = " ".join(f"{k.split('-')[-1][:4]}:{int(v['count'])}"
                        for k, v in colls.items() if v["count"])
        rows.append(
            f"| {arch} | {shape} | {mesh} | ok | {r['compile_s']}s "
            f"| {_fmt_n(mem['argument_bytes_per_device'])}B "
            f"| {_fmt_n(mem['temp_bytes_per_device'])}B | {cstr} |")
    return "\n".join(rows)


def grid_table(results: List[Dict]) -> str:
    """One row an architecture, one column a shape (the single-pod exact
    cells): the dominant term and its time, the roofline fraction, and
    ✗ where the cell does not fit the card's memory."""
    from repro_torch.launch.shapes import SHAPES
    cells: Dict[str, Dict[str, str]] = {}
    for r in results:
        if r.get("multi_pod") or not r.get("exact"):
            continue
        if r["status"] == "ok":
            t = r["roofline"]
            dom = t["dominant"]
            cell = (f"{dom.replace('_s', '')} {_fmt_s(t[dom])} "
                    f"({t['roofline_fraction']:.3f})"
                    + ("" if _fits(r["memory"]) else " ✗"))
        else:
            cell = r["status"]
        cells.setdefault(r["arch"], {})[r["shape"]] = cell
    shapes = list(SHAPES)
    rows = ["| arch | " + " | ".join(shapes) + " |",
            "|---|" + "---|" * len(shapes)]
    for arch, row in cells.items():
        rows.append(f"| {arch} | "
                    + " | ".join(row.get(s, "—") for s in shapes) + " |")
    return "\n".join(rows)


def bottleneck_notes(results: List[Dict]) -> str:
    lines = []
    from repro_torch.launch.shapes import SHAPES
    for r in results:
        if r.get("multi_pod") or not r.get("exact") or r["status"] != "ok":
            continue
        kind = SHAPES[r["shape"]].kind
        dom = r["roofline"]["dominant"]
        hint = FIX_HINTS.get((dom, kind), "—")
        lines.append(f"- **{r['arch']} × {r['shape']}** — bottleneck "
                     f"{dom.replace('_s', '')}: {hint}.")
    return "\n".join(lines)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch")
    ap.add_argument("--section",
                    choices=["roofline", "dryrun", "notes", "grid"],
                    default="roofline")
    args = ap.parse_args()
    results = load_results(args.results)
    if args.section == "roofline":
        print(roofline_table(results))
    elif args.section == "dryrun":
        print(dryrun_table(results))
    elif args.section == "grid":
        print(grid_table(results))
    else:
        print(bottleneck_notes(results))


if __name__ == "__main__":
    main()

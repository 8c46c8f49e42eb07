"""What a run reads from the checkout: ``BENCHMARK.json``, the cell's
file, its configuration's file, the configuration's family module and the
per-layer metrics' readers, each found by name.

A cell is ``workloads/<cell>.json``: its configuration's name, its path
(``serve`` or ``train``), the traffic or job, and the output check. A
configuration is the file ``BENCHMARK.json`` names for it; its ``model``
section names the program family whose module, ``families/<family>.py``,
knows the architecture (its sizes, weights, plain reference and counts;
``families/__init__.py``). A per-layer metric is ``metrics/<metric>.py``,
a module with ``LAYER``, ``UNIT``, ``SOURCE``, ``MOVES`` and
``read(run) -> float | None``. Which metrics a cell reports comes from
``BENCHMARK.json`` alone: an end-to-end metric in the cells its
``workloads`` lists (every cell without the key), a per-layer metric in
the cells its ``workloads`` lists (without the key, every cell that
reports the metric it moves).

So a configuration joins with new files and new entries, and no file here
changes: its ``configs/<name>.json``; ``families/<family>.py`` if its
family is new; a ``workloads/<cell>.json`` for each of its cells; its
entries under ``configs`` and ``workloads`` in ``BENCHMARK.json`` (and its
cells added to the ``workloads`` lists of the metrics they report); and a
reader ``metrics/<metric>.py`` for any new per-layer metric.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, here: Path = HERE) -> Dict[str, Any]:
    path = here / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no cell {name!r}: {path} is missing")
    spec = json.loads(path.read_text())
    if spec.get("name") != name:
        raise SystemExit(f"{path} names itself {spec.get('name')!r}")
    return spec


def config(name: str, bench: Dict[str, Any], root: Path = ROOT
           ) -> Dict[str, Any]:
    for c in bench["configs"]:
        if c["name"] == name:
            spec = json.loads((root / c["file"]).read_text())
            if spec.get("name") != name:
                raise SystemExit(f"{c['file']} names itself "
                                 f"{spec.get('name')!r}")
            return spec
    raise SystemExit(f"BENCHMARK.json has no configuration {name!r}")


def _listed(metric: Dict[str, Any], cell_name: str) -> Optional[bool]:
    w = metric.get("workloads")
    return None if w is None else cell_name in w


def end_to_end(bench: Dict[str, Any], cell_name: str) -> List[Dict]:
    return [m for m in bench["end_to_end"]
            if _listed(m, cell_name) in (None, True)]


def per_layer(bench: Dict[str, Any], cell_name: str) -> List[Dict]:
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        listed = _listed(m, cell_name)
        if listed or (listed is None and m["moves"] in e2e):
            out.append(m)
    return out


def reader(name: str, here: Path = HERE) -> ModuleType:
    """The reader module of per-layer metric ``name`` (``metrics/<name>.py``;
    names may hold dots, so it is loaded from its path)."""
    path = here / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no reader for metric {name!r}: {path}")
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod

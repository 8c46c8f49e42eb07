"""Run one cell of the benchmark and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell is ``perfbench/workloads/<cell>.json``;
the system under test is ``repro_torch`` (``src/``). With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (``perfbench/metrics/<metric>.py``), the device's busy
seconds and the profiled slice's breakdown. Each number the output check
compared is printed beside its limit, on standard error and under
``checks`` at the end of the line. Without a CUDA card, or with fewer than
the cell asks for, the run fails and prints no result.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: a run that has not ended after this many seconds prints every thread's
#: stack and exits (no result): a hang fails within the run's limit
HANG_S = 340

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    the program (``src/``) and the harness importable."""
    cache = ROOT / "build" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    # the harness's modules are imported as ``perfbench.*``, never as
    # top-level names from the script's own directory
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path
                   if str(Path(p or ".").resolve()) != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None, *, check_device: bool = True) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if argv is None:
        faulthandler.dump_traceback_later(HANG_S, exit=True)
    _environment()
    from perfbench import harness, spec
    bench = spec.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        raise SystemExit(f"BENCHMARK.json has no cell {args.workload!r}")
    cell = spec.cell(args.workload)
    conf = spec.config(cell["config"], bench)
    device = harness.device_for(entry["chips"], check_device)
    result = harness.run_cell(bench, cell, conf, args.seed, args.seconds,
                              bool(args.trace), device, T_START)
    found = loaded_forbidden()
    if found:
        print(f"forbidden modules loaded in the run's process: {found}",
              file=sys.stderr)
        raise SystemExit(4)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

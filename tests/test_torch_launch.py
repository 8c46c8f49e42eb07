"""The port's dry run, sweep and roofline report on the CPU: the
reference's debug-mesh cells (``tests/launch/test_launch.py``) through
``python -m repro_torch.launch.dryrun`` (a subprocess each: a process
holds one fake process group, of one size), the documented skip, a sweep
cell and its table, and that importing the mesh factories starts nothing.
"""
import json
import os
import subprocess
import sys

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.shapes import SHAPES, is_applicable
from repro_torch.roofline import report

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def run_dryrun(arch, shape, *flags, timeout=420):
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--debug-mesh", *flags]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout[proc.stdout.index("{"):])


def _counted(r):
    assert r["status"] == "ok"
    assert r["roofline"]["flops_global"] > 0
    assert r["cost"]["flops_per_device"] > 0
    assert r["cost"]["collective_bytes_per_device"] > 0
    assert r["memory"]["argument_bytes_per_device"] > 0
    assert set(r["collectives"]) == {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute"}
    assert r["op_hist"]


def test_dryrun_decode_cell_exact():
    r = run_dryrun("h2o_danube3_4b", "decode_32k", "--exact")
    _counted(r)
    assert r["mesh"] == {"data": 2, "model": 2}
    # one device's share of a global decode: a quarter of the cache
    cfg = get_config("h2o_danube3_4b")
    cache = 2 * cfg.n_layers * 128 * cfg.window * cfg.padded_kv_heads \
        * cfg.resolved_head_dim * 2
    assert r["memory"]["argument_bytes_per_device"] < cache
    # the cache is written in place: its bytes are an output's and an
    # argument's at once
    assert 0 < r["memory"]["alias_bytes_per_device"] \
        <= r["memory"]["output_bytes_per_device"]


def test_dryrun_multipod_mesh():
    r = run_dryrun("h2o_danube3_4b", "decode_32k", "--multi-pod")
    _counted(r)   # proves the pod axis shards
    assert r["mesh"] == {"pod": 2, "data": 2, "model": 2}


def test_dryrun_long_context_ssm():
    r = run_dryrun("mamba2_370m", "long_500k")
    _counted(r)


def test_dryrun_train_cell():
    r = run_dryrun("paper_demo", "train_4k", "--exact")
    _counted(r)
    assert r["cost"]["n_repeat_scaling"] == 4
    assert r["roofline"]["model_flops"] > 0
    assert r["memory"]["alias_bytes_per_device"] == 0   # out of place
    # the grad sync as reduce-scatters, with the constraint on
    rs = run_dryrun("paper_demo", "train_4k", "--exact", "--grad-rs")
    assert rs["collectives"]["reduce-scatter"]["bytes"] > \
        r["collectives"]["reduce-scatter"]["bytes"]
    assert rs["collectives"]["all-reduce"]["bytes"] < \
        r["collectives"]["all-reduce"]["bytes"]


def test_dryrun_on_one_card_counts_no_collective():
    """``chip_smoke.py`` 26a's cell: phase 5's decode step on the card's
    1×1 mesh, where every leaf replicates."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "paper_demo", "--shape", "decode_32k", "--mesh", "1x1", "--batch",
         "8", "--seq-len", "1024"], capture_output=True, text=True,
        timeout=420, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert r["status"] == "ok" and r["chips"] == 1
    assert r["mesh"] == {"data": 1, "model": 1}
    assert r["cost"]["collective_bytes_per_device"] == 0
    # one card's share is the whole program: 2 N a token and attention
    assert r["cost"]["flops_per_device"] > r["roofline"]["model_flops"]


def test_dryrun_long_skip_for_full_attention():
    ok, reason = is_applicable(get_config("llama3_405b"),
                               SHAPES["long_500k"])
    assert not ok and "quadratic" in reason
    ok, _ = is_applicable(get_config("zamba2_1p2b"), SHAPES["long_500k"])
    assert ok
    ok, _ = is_applicable(get_config("h2o_danube3_4b"), SHAPES["long_500k"])
    assert ok   # SWA bounds the cache
    r = run_cell("llama3_405b", "long_500k", multi_pod=False, exact=True)
    assert r["status"] == "skipped" and "quadratic" in r["reason"]


def test_mesh_factories_start_nothing_at_import():
    """Importing the mesh module touches no CUDA state and starts no
    process group; the factories are functions."""
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.launch.mesh as m\n"
            "assert not dist.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert callable(m.make_production_mesh)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr[-2000:]


def test_sweep_cell_and_report_table(tmp_path):
    """One sweep cell on the production mesh (32×8), its JSON, and the
    report's rows."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--out-dir",
         str(tmp_path), "--only-arch", "mamba2_370m", "--only-shape",
         "long_500k", "--skip-multi", "--timeout", "400"],
        capture_output=True, text=True, timeout=420, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = report.load_results(str(tmp_path))
    assert len(results) == 1 and results[0]["status"] == "ok"
    assert results[0]["mesh"] == {"data": 32, "model": 8}
    table = report.roofline_table(results)
    assert "| mamba2-370m | long_500k | ok |" in table
    assert "fits 80 GB" in table.splitlines()[0]
    assert "| 32×8 | ok |" in report.dryrun_table(results)
    assert "mamba2-370m × long_500k" in report.bottleneck_notes(results)
    grid = report.grid_table(results).splitlines()
    assert grid[0] == "| arch | train_4k | prefill_32k | decode_32k | " \
        "long_500k |"
    assert grid[2].startswith("| mamba2-370m | — | — | — | ")


def test_report_reads_the_reference_keys():
    """A result in the reference's keys (16 GB check, its mesh) prints."""
    ref = {"arch": "a", "shape": "decode_32k", "multi_pod": False,
           "exact": True, "status": "ok", "compile_s": 1.0,
           "memory": {"argument_bytes_per_device": 1e9,
                      "temp_bytes_per_device": 2e9, "fits_16g_hbm": True},
           "collectives": {"all-gather": {"count": 2, "bytes": 8.0}},
           "roofline": {"compute_s": 1e-3, "memory_s": 2e-3,
                        "collective_s": 0.0, "dominant": "memory_s",
                        "roofline_fraction": 0.5,
                        "useful_flops_ratio": 0.9}}
    assert "| a | decode_32k | ok | 1.0ms | 2.0ms |" in \
        report.roofline_table([ref])
    assert "| a | decode_32k | 16×16 | ok |" in report.dryrun_table([ref])

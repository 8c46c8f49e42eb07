"""Helpers of the CPU tests: a cell and its configuration cut to a size
the CPU runs in seconds (the program's reduced config, few slots, short
requests), driven through the whole harness but the look for a card."""
from __future__ import annotations

import copy
import time
from typing import Any, Dict

import torch

from perfbench import harness, spec


def small(cell_name: str) -> Dict[str, Any]:
    # one thread a test process: the tests run several processes at once
    torch.set_num_threads(1)
    bench = spec.benchmark()
    cell = copy.deepcopy(spec.cell(cell_name))
    conf = copy.deepcopy(spec.config(cell["config"], bench))
    from repro_torch.configs import get_config
    conf["program"]["reduced"] = True
    conf["model"] = harness.model_sizes(
        get_config(conf["program"]["name"], reduced=True))
    if cell["path"] == "serve":
        cell["engine"].update(max_batch=3, max_cache_len=128)
        cell["traffic"].update(clients=3, prompt_len=[8, 24],
                               output_len=[12, 32], max_total=128, pool=4096)
        cell["check"]["sample_tokens"] = 80
    else:
        cell["job"].update(batch=2, seq_len=64)
    return {"bench": bench, "cell": cell, "conf": conf}


def run_small(cell_name: str, seconds: float = 2.0, trace: bool = False,
              seed: int = 2 ** 31 + 7) -> Dict[str, Any]:
    s = small(cell_name)
    return harness.run_cell(s["bench"], s["cell"], s["conf"], seed,
                            seconds, trace, torch.device("cpu"),
                            time.monotonic())

"""What the benchmark knows of a model's architecture, one module a
program family: ``families/<family>.py``, where ``<family>`` is the
configuration file's ``model.family``, found by name as cells and metric
readers are. A new family is a new file here; nothing else in
``perfbench/`` changes for it.

A family module provides:

- ``sizes(cfg)``: the sizes of a ``repro_torch`` configuration, keyed as
  a configuration file's ``model`` section (``harness.program_config``
  holds the file to them);
- ``make_params(cfg, seed, device)``: the weights, in the program's
  layout, drawn from the seed (the helpers are ``weights``');
- ``Model``: the fp32 plain model, a ``reference.model.Model`` that
  composes the shared pieces (the SSD closed form, the conv, attention,
  the MLP) into ``hidden``, in each precision the output checks and their
  controls use;
- ``leaves(m)`` and ``flops_params(m)`` of a ``model`` section
  (``counts.model``);
- the decode step's byte terms ``weight_bytes(m, dtype)``,
  ``state_bytes(m, dtype)`` and ``kv_row_bytes(m, dtype)``
  (``counts.decode``).

The entry points that readers, cells and tests use (``weights``,
``reference.check``, ``reference.train``, ``counts.*``, ``harness``,
``testing``) look the family up here and call its module.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Mapping, Optional

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_LOADED: Dict[Path, ModuleType] = {}


def module(name: str, here: Optional[Path] = None) -> ModuleType:
    """The module of family ``name``: ``<here>/<name>.py`` (``here``
    defaults to this directory), loaded once a process. A family without
    a module stops the run here, before any weight is made."""
    if not _NAME.match(str(name)):
        raise SystemExit(f"no family {name!r}: not a module's name")
    path = (here or HERE) / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no family {name!r}: {path} is missing")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"perfbench_family_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def of(model: Mapping[str, Any]) -> ModuleType:
    """The family module of a configuration file's ``model`` section."""
    return module(model["family"])

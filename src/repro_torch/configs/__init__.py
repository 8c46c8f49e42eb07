"""Architecture registry of the port.

``get_config(name)`` returns the exact published configuration;
``get_config(name, reduced=True)`` the CPU smoke-test reduction. Every
configuration of the reference package has a module here
(``ARCHITECTURES``): the decoder-only families run through ``models.lm``,
the audio enc-dec (``whisper_large_v3``) through ``models.encdec``. The
port's own configurations, of families the reference lacks
(``PORT_ARCHITECTURES``: granite-4.0-h-small), are found the same way.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

ARCHITECTURES = ["paper_demo", "mamba2_370m", "h2o_danube3_4b",
                 "deepseek_coder_33b", "llama3_405b", "command_r_plus_104b",
                 "qwen3_moe_235b_a22b", "llama4_scout_17b_16e",
                 "zamba2_1p2b", "whisper_large_v3", "internvl2_26b"]
#: configurations the reference package has no counterpart of
PORT_ARCHITECTURES = ["granite_4_0_h_small"]

# ``canonical`` maps '-' to '_' first: a key here is a name in that form
# whose module is spelled otherwise (danube's and llama4's own ``cfg.name``)
_ALIASES = {"h2o_danube_3_4b": "h2o_danube3_4b",
            "llama4_scout_17b_a16e": "llama4_scout_17b_16e",
            "granite_4p0_h_small": "granite_4_0_h_small"}


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "p")
    return _ALIASES.get(name, name)


def get_config(name: str, reduced: bool = False, **overrides) -> ModelConfig:
    name = canonical(name)
    if name not in ARCHITECTURES + PORT_ARCHITECTURES:
        raise NotImplementedError(
            f"config {name!r} is not ported yet; see ROADMAP "
            f"(ported: {ARCHITECTURES + PORT_ARCHITECTURES})")
    cfg: ModelConfig = importlib.import_module(
        f"repro_torch.configs.{name}").config()
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg

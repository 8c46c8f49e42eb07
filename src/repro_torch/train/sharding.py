"""Per-shape sharding rule tables (counterpart of
``repro/train/sharding.py``).

The logical-axis vocabulary is fixed (``repro_torch.sharding.DEFAULT_RULES``);
what varies across the four assigned input shapes is how activations map
to the mesh:

* ``train`` / ``prefill``: batch + FSDP over (pod, data); weights TP over
  model; activation heads over model; KV-seq unsharded (prefill caches
  shard on head_dim via the weight "tp" rule).
* ``decode``: flash-decoding layout — KV cache sequence over *model*,
  activation heads replicated (the per-token tensors are tiny; the cache
  is the object being parallelized), batch over (pod, data).
* ``long`` (seq 500k, batch 1): batch unshardable → KV window/state
  sequence over (pod, data) (sequence parallelism), SSM state heads over
  model, activation heads replicated.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.sharding import DEFAULT_RULES

SHAPE_KINDS = ("train", "prefill", "decode", "long")


def rules_for(kind: str) -> Dict[str, object]:
    if kind not in SHAPE_KINDS:
        raise ValueError(f"unknown shape kind {kind!r}")
    rules = dict(DEFAULT_RULES)
    if kind == "decode":
        rules.update({"kv_seq": "model", "act_heads": None})
    elif kind == "long":
        rules.update({"batch": None, "kv_seq": ("pod", "data"),
                      "act_heads": None})
    return rules


def batch_logical_axes(batch_tree: Dict[str, Any]) -> Dict[str, tuple]:
    """Logical axes for input batches: leading batch dim, rest replicated."""
    return {k: ("batch",) + (None,) * (len(x.shape) - 1)
            for k, x in batch_tree.items()}

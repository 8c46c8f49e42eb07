"""Bytes a dense-mode decode step needs: every weight read once, the
SSM and conv state of each live slot read once and written once, and (a
hybrid) the KV positions each live slot holds read once and its new row
written once. Positions held, not the cache's length: a step that reads
the empty rest of its cache does more than it needs."""
from __future__ import annotations

from typing import Any, Mapping

from perfbench.counts.model import leaves, sites

_SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def weight_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """The weights a step reads: the token rows of the (tied) table, every
    layer and the shared block; the fp32 leaves (A_log, D, dt_bias, norm
    scales) at 4 bytes."""
    s, d, L = m["ssm"], m["d_model"], m["n_layers"]
    di = s["expand"] * d
    H = di // s["head_dim"]
    lv = leaves(m)
    fp32 = L * (3 * H + di + d) + d
    n = m["vocab_size"] * d + lv["layers"] + lv["final_norm"] - fp32
    if m["family"] == "hybrid":
        w = 2 * d
        fp32 += 2 * w
        n += lv["shared"] + lv["proj"] - 2 * w
    return n * _SIZE[dtype] + fp32 * 4


def state_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """One slot's SSM state (fp32) and conv state (the activations' type),
    over all layers."""
    s, d = m["ssm"], m["d_model"]
    di = s["expand"] * d
    H, N, G = di // s["head_dim"], s["state_dim"], s["n_groups"]
    per = 4 * H * s["head_dim"] * N \
        + _SIZE[dtype] * (s["conv_width"] - 1) * (di + 2 * G * N)
    return m["n_layers"] * per


def kv_row_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """One position's K and V over every shared-block site (0 without
    attention)."""
    if m["family"] != "hybrid":
        return 0
    return sites(m) * 2 * m["n_kv_heads"] * m["head_dim"] * _SIZE[dtype]


def step_bytes(m: Mapping[str, Any], dtype: str, live_slots: int,
               positions_held: int) -> int:
    """A step over ``live_slots`` slots that together hold
    ``positions_held`` KV positions before it."""
    return (weight_bytes(m, dtype)
            + 2 * live_slots * state_bytes(m, dtype)
            + (positions_held + live_slots) * kv_row_bytes(m, dtype))

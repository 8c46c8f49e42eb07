"""Bytes a dense-mode decode step needs: every weight read once, each
live slot's recurrent state (SSM and conv) read once and written once,
and the KV positions each live slot holds read once and its new row
written once. Positions held, not the cache's length: a step that reads
the empty rest of its cache does more than it needs. Each family's module
(``families/<family>.py``) gives the three terms for its layers."""
from __future__ import annotations

from typing import Any, Mapping

from perfbench import families

#: bytes an element of each type a configuration file may state
SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def weight_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """The weights a step reads: the token rows of the table and every
    layer, each leaf in its own type."""
    return families.of(m).weight_bytes(m, dtype)


def state_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """One slot's recurrent state over all layers (0 without any)."""
    return families.of(m).state_bytes(m, dtype)


def kv_row_bytes(m: Mapping[str, Any], dtype: str) -> int:
    """One position's K and V over every attention layer (0 without
    attention)."""
    return families.of(m).kv_row_bytes(m, dtype)


def step_bytes(m: Mapping[str, Any], dtype: str, live_slots: int,
               positions_held: int) -> int:
    """A step over ``live_slots`` slots that together hold
    ``positions_held`` KV positions before it."""
    return (weight_bytes(m, dtype)
            + 2 * live_slots * state_bytes(m, dtype)
            + (positions_held + live_slots) * kv_row_bytes(m, dtype))

"""Bytes and operations of one call of a dropless MoE block's routed
experts (the three grouped products of ``models/moe.py``): each expert
that receives a row reads its three weight matrices once, each row is
read once and its output written once, and a row costs the three
products of ``d x d_ff`` (6 d d_ff operations). The intermediate rows and
the router are not counted."""
from __future__ import annotations

from typing import Any, Mapping, Tuple

from perfbench.counts.decode import SIZE

#: the grouped products a call launches (``wi``, ``wg``, ``wo``)
LAUNCHES_PER_CALL = 3


def call(m: Mapping[str, Any], dtype: str, rows: float,
         experts_hit: float) -> Tuple[float, float]:
    """(bytes, flops) of a call that runs ``rows`` assignments over
    ``experts_hit`` experts (means over calls may be fractional)."""
    d, ff = m["d_model"], m["moe"]["d_ff"]
    item = SIZE[dtype]
    n_bytes = experts_hit * 3 * d * ff * item + rows * 2 * d * item
    return float(n_bytes), float(rows * 6 * d * ff)

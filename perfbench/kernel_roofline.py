"""A kernel family's share of its roofline in a profiled slice: the
launches counted by one grid's name, each at the bound of one call at the
run's shape, over the device time of every grid of the family."""
from __future__ import annotations

from typing import Any, Optional, Sequence

from perfbench.counts import ssd
from perfbench.counts.peaks import bound_s

_ITEM = {"float32": 4, "bfloat16": 2}


def share(run: Any, direction: str, counter: str,
          family: Sequence[str]) -> Optional[float]:
    tl = run.timeline
    if tl is None:
        return None
    launches, secs = 0, 0.0
    for name, (n, s) in tl.by_name().items():
        if counter in name:
            launches += n
        if any(f in name for f in family):
            secs += s
    if not launches or secs <= 0:
        return None
    m, s_ = run.model, run.model["ssm"]
    H = s_["expand"] * m["d_model"] // s_["head_dim"]
    shape = (run.batch, run.seq_len, H, s_["head_dim"], s_["n_groups"],
             s_["state_dim"], s_["chunk_size"], _ITEM[run.dtype])
    if direction == "forward":
        n_bytes, flops = ssd.forward(*shape, final=False)
    else:
        n_bytes, flops = ssd.backward(*shape)
    return 100.0 * launches * bound_s(n_bytes, flops, run.dtype) / secs

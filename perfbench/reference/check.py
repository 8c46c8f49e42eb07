"""The output check of a serve cell: how far below the reference's best
logit each served token lies.

For each sampled request the fp32 reference runs once over its prompt and
the tokens it was served (teacher-forced), and at each served position
reads ``max(logits) - logits[served token]``: 0 where the program chose
the reference's argmax, small where bf16 rounding flipped a near tie,
large where the program served a token the model does not favour. The
number compared is the widest gap over every sampled token. The control
(``control=True``) puts the reference in fp8 in the program's place: at
the same positions it takes the fp8 model's first choice and reads that
token's gap under the fp32 reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.model import Model, forward_logits

Sample = Tuple[np.ndarray, Sequence[int]]


def widest_gaps(model: Mapping[str, Any], params: Dict[str, Any],
                samples: List[Sample], device: Any,
                control: bool = False) -> Dict[str, float]:
    """``{"served": widest gap of the served tokens}``, and with
    ``control`` also ``{"control": widest gap of the fp8 model's first
    choices}``, over ``samples`` of (prompt, served tokens)."""
    ref = Model(model, "fp32")
    low = Model(model, "fp8") if control else None
    out = {"served": 0.0}
    if control:
        out["control"] = 0.0
    for prompt, served in samples:
        served = [int(t) for t in served]
        seq = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(served[:-1], np.int64)])
        toks = torch.as_tensor(seq, device=device)[None]
        start = len(prompt) - 1
        lg = forward_logits(ref, params, toks, start)[0]
        best = lg.max(dim=-1).values
        idx = torch.arange(lg.shape[0], device=lg.device)
        got = torch.as_tensor(served, device=lg.device)
        out["served"] = max(out["served"],
                            float((best - lg[idx, got]).max()))
        if low is not None:
            pick = forward_logits(low, params, toks, start)[0].argmax(-1)
            out["control"] = max(out["control"],
                                 float((best - lg[idx, pick]).max()))
        del lg
    return out

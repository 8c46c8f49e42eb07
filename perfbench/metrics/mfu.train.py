"""Model FLOPs of the steps trained in the window, 6 N a token (N the
weights a token passes through, ``counts.model.flops_params``; remat's
recompute not counted), over the window at fp32's peak outside the
tensor cores: the whole step's share of the card."""
from perfbench.counts.model import flops_params
from perfbench.counts.peaks import FLOPS

LAYER = "train step"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(run):
    n = run.steps_done
    if not n:
        return None
    flops = 6.0 * flops_params(run.model) * n * run.batch * run.seq_len
    return 100.0 * flops / run.window_s / FLOPS[run.dtype]

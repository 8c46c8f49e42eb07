"""Model FLOPs of the tokens delivered in the window, 2 N a token (N the
weights a token passes through, ``counts.model.flops_params``), over the
window at bf16's peak: the whole step's share of the card."""
from perfbench.counts.model import flops_params
from perfbench.counts.peaks import FLOPS

LAYER = "model step"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "decode_tokens_per_s"


def read(run):
    tokens = run.tokens_in_window()
    if not tokens:
        return None
    flops = 2.0 * flops_params(run.model) * tokens
    return 100.0 * flops / run.window_s / FLOPS[run.dtype]

"""95th percentile of the ``req.prefill`` spans (prefill dispatch to its
first token's continuation) that start in the window.
An eager prefill holds every slot's next decode step behind it, and
in the closed loop the client waits for it."""
from perfbench.spans import span_p95

LAYER = "prefill"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "decode_tokens_per_s"


def read(run):
    return span_p95(run, "req.prefill", 1e3)

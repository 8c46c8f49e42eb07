"""95th percentile, over the continuations that ran in the window, of
the time from their operations' completion being found (``cont.ready``)
to their callback running (``cont.ran``): the tracer's
``complete_to_run`` edge, exact per continuation (the tracer's own
histogram keeps power-of-two buckets). Each decode step's tokens reach
their clients in such a continuation, so its wait delays every token."""
from perfbench.traffic.stats import percentile

LAYER = "continuation notification"
UNIT = "us"
SOURCE = "program_span"
MOVES = "decode_tokens_per_s"


def read(run):
    ready = {e.rid: e.ts for e in run.events if e.kind == "cont.ready"}
    waits = [(e.ts - ready[e.rid]) * 1e6 for e in run.events
             if e.kind == "cont.ran" and e.rid in ready
             and run.in_window(e.ts)]
    return percentile(waits, 0.95) if waits else None

"""95th percentile of the ``req.admit`` spans (arrival to seated) that
start in the window, from the program's tracer.
In the closed loop a client sends again only once its request is
served, so the time a request waits to be seated holds the loop's
throughput back."""
from perfbench.spans import span_p95

LAYER = "intake"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "decode_tokens_per_s"


def read(run):
    return span_p95(run, "req.admit", 1e3)

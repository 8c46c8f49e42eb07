"""95th percentile of the milliseconds the prefills dispatched in the
window span on the card's stream: the program's ``dev.prefill`` events,
the device clock between a pair of CUDA timing events recorded before a
prefill's first kernel and after its last. This is not the card's busy
time: where the host enqueues an eager prefill slower than the card runs
it, the stream waits between kernels and the span is the host's enqueue
time, so a faster host loop moves it as much as faster kernels would."""
from perfbench.spans import span_p95

LAYER = "host loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "decode_tokens_per_s"


def read(run):
    return span_p95(run, "dev.prefill", 1e3)

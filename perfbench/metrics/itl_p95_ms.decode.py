"""95th percentile over every gap between consecutive tokens delivered
to one request within the window (the requests' own stamps). A tail
whose runs spread too widely for a bound (PERF.md), so it stands here
beside the end-to-end metrics: about one gap in ten holds an eager
prefill, which stalls every slot's next step and so the loop's
throughput."""
from perfbench.traffic.stats import percentile

LAYER = "model step"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "decode_tokens_per_s"


def read(run):
    gaps = run.gaps_ms()
    return percentile(gaps, 0.95) if gaps else None

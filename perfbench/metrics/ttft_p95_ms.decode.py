"""95th percentile, over every request sent in the window that got its
first token, of submission to first token delivered (the requests' own
stamps). A tail of some hundreds of requests: its runs spread too widely
for a bound, so it stands here beside the end-to-end metrics. In the
closed loop a client sends again only once served, so a longer wait for
the first token holds the loop's throughput back."""
from perfbench.traffic.stats import percentile

LAYER = "intake"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "decode_tokens_per_s"


def read(run):
    ttft = run.ttfts_ms()
    return percentile(ttft, 0.95) if ttft else None

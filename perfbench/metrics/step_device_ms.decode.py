"""Median device milliseconds of a decode step in the window: the
program's ``dev.step`` events, a pair of CUDA timing events around each
graph replay, stamped at its dispatch. ``decode_bytes_roofline`` and
``mfu.decode`` divide by the window's wall time, which the host paces
between steps; this reads the card's time for a step alone."""
from statistics import median

LAYER = "model step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "decode_tokens_per_s"


def read(run):
    durs = [e.dur * 1e3 for e in run.events
            if e.kind == "dev.step" and run.in_window(e.ts)]
    return median(durs) if durs else None

"""The bytes the window's decode steps need at the card's memory rate,
as a share of the window: every weight once a step, each live slot's SSM
and conv state read and written once, and (hybrid) the KV positions each
live slot holds read once and its new row written once
(``counts.decode``). A decode token j >= 1 of a request with a prompt of
p tokens came from a step in which its slot held p + j - 1 positions."""
from perfbench.counts import decode
from perfbench.counts.peaks import HBM_BYTES_PER_S

LAYER = "model step"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "decode_tokens_per_s"


def read(run):
    steps = run.delta("steps")
    if not steps:
        return None
    m, dt = run.model, run.dtype
    state, row = decode.state_bytes(m, dt), decode.kv_row_bytes(m, dt)
    n = steps * decode.weight_bytes(m, dt)
    for r in run.requests:
        plen = len(r.prompt)
        for j, t in enumerate(r.token_times):
            if j and run.in_window(t):
                n += 2 * state + (plen + j) * row
    return 100.0 * n / HBM_BYTES_PER_S / run.window_s

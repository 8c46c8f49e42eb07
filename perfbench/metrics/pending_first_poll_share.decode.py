"""Share of the engine's completion ops (decode steps and prefills) still
running on the card at their first poll over the window
(``TensorOp.PENDING_AT_FIRST_POLL``): near 100% the loop never waits on
the card."""
LAYER = "completion discovery"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "decode_tokens_per_s"


def read(run):
    ops = run.delta("steps") + run.delta("prefills")
    if not ops:
        return None
    return 100.0 * (run.pending1 - run.pending0) / ops

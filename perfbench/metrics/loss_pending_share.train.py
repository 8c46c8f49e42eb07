"""Share of the window's loss readbacks still running on the card at
their first poll: near 100% the loop never waits on the card."""
LAYER = "completion discovery"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(run):
    if not run.host_s:
        return None
    return 100.0 * run.pending / len(run.host_s)

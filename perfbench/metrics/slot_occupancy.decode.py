"""Share of the decode steps' slots that held a live request over the
window: ``slot_steps / (steps * max_batch)`` from ``ServeEngine.stats``."""
LAYER = "admission and batching"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "decode_tokens_per_s"


def read(run):
    steps = run.delta("steps")
    if not steps:
        return None
    return 100.0 * run.delta("slot_steps") / (steps * run.max_batch)

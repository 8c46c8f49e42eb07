"""Host milliseconds to enqueue one decode step over the window:
``stats["dispatch_s"] / stats["steps"]`` of ``ServeEngine``."""
LAYER = "host loop"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "decode_tokens_per_s"


def read(run):
    steps = run.delta("steps")
    if not steps:
        return None
    return 1e3 * run.delta("dispatch_s") / steps

"""Share of the profiled slice of the training window in which no kernel
ran on the card (``torch.profiler`` timeline)."""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(run):
    tl = run.timeline
    if tl is None or not tl.kernels or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)

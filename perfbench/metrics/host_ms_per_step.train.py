"""Host milliseconds an iteration of the training loop took over the
window (batch from the prefetch, upload, dispatch, loss readback, the
CR's poll), by the host clock around each."""
LAYER = "trainer loop"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(run):
    if not run.host_s:
        return None
    return 1e3 * sum(run.host_s) / len(run.host_s)

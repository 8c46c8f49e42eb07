"""The SSD scan's backward kernels against their bound in the profiled
slice: launches (one ``ssd_bwd_pass`` grid a call) times the bound of a
call (``counts.ssd.backward``), over the device time of every backward
grid (``ssd_bwd_*``)."""
from perfbench.kernel_roofline import share

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(run):
    return share(run, "backward", "ssd_bwd_pass", ("ssd_bwd_",))

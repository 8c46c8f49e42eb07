"""The SSD scan's forward kernels against their bound in the profiled
slice: launches (one ``ssd_chunk_scan`` grid a call) times the bound of a
call at the train step's shape (``counts.ssd.forward``: bytes at the
memory's rate or operations at fp32's peak, the larger), over the device
time of every forward grid (``ssd_chunk_state``, ``ssd_state_pass``,
``ssd_chunk_scan``)."""
from perfbench.kernel_roofline import share

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(run):
    return share(run, "forward", "ssd_chunk_scan",
                 ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan"))

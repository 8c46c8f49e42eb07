"""One serve step as one launch: the port's counterpart of the reference's
``jax.jit`` of its steps (``repro/serve/engine.py``, ``ServeEngine.__init__``).

``StepGraph`` owns a step: a function of no arguments that reads the
engine's static input buffers and returns its outputs. On a CUDA device
it runs the function once to warm up (cuBLAS handles, the kernel library)
and captures it with ``torch.cuda.graph`` when it is constructed; each
call then replays the graph, one launch for the whole step whatever the
number of kernels inside, and returns the same output tensors. On the CPU
each call runs the function eagerly on the same buffers. The device
decides: there is no switch, and a capture that fails raises.

Which steps are captured: the fused paged decode step, the fused paged
verify step (speculative decoding) and the dense-mode SSM decode step.
Prefill and suffix prefill stay eager, because their lengths vary by
request.

What keeps a replay right:

* the step reads its inputs only from static buffers, which the engine
  fills in place ahead of each call (non-blocking copies from pinned
  memory, queued on the same stream) and never rebinds;
* tensors the step allocates (its outputs, the paged kernel's partials,
  the SSD scan's scratch) come from the graph's private memory pool and
  keep their addresses across replays. That is right only because every
  size is computed from host-known shapes, never read from the device;
* the warm-up really executes, so the engine constructs a step before any
  slot is seated: a paged step with ``n_valid = 0`` in every row writes
  nothing, and the SSM step's state rows are overwritten by the next
  prefill into each slot;
* a step's outputs are overwritten by the next replay, so the engine
  copies them to a fresh pinned host tensor right after each call, one
  per step in flight, and reads only that copy.

The kernel wrappers count launches with a Python increment (``LAUNCHES``),
which runs once at capture and never on replay. ``StepGraph`` records each
kernel module's increase during capture and adds it back on every replay,
so the counts still mean launches on the card.

Programmatic dependent launch (the paged kernel's merge, the SSD scan's
second and third grids) is captured as it is launched: the stream capture
keeps the launch attribute as a programmatic edge of the graph
(``chip_smoke.py`` phase 3g counts those edges).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.kernels import (flash_attention, paged_attention, rmsnorm,
                                 ssd_scan)

#: the kernel modules whose ``LAUNCHES`` a replay adds back
KERNEL_MODULES = (flash_attention, paged_attention, rmsnorm, ssd_scan)


class StepGraph:
    """A step function over static buffers: captured and replayed as one
    CUDA graph on a CUDA device, called eagerly on the CPU.

    ``fn()`` takes no arguments; it closes over the buffers it reads and
    returns its outputs (a tensor or a tuple of tensors). Construct it on
    the thread and device the engine runs on, with no other capture under
    way in the process; replays may come from any thread."""

    def __init__(self, fn: Callable[[], Any], device: torch.device) -> None:
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.outputs: Any = None
        self.launches: Tuple[Tuple[Any, int], ...] = ()
        self.replays = 0
        if self.device.type == "cuda":
            self._capture()
        elif self.device.type != "cpu":
            raise ValueError(f"StepGraph: no step graphs on {self.device}")

    def _capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = [m.LAUNCHES for m in KERNEL_MODULES]
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a client submitting,
        # another engine's loop replaying) do not void this capture
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            self.outputs = self.fn()
        self.launches = tuple(
            (m, m.LAUNCHES - n) for m, n in zip(KERNEL_MODULES, before)
            if m.LAUNCHES != n)
        # the wrappers' increments during capture counted no launch
        for m, n in self.launches:
            m.LAUNCHES -= n
        self.graph = graph

    def __call__(self) -> Any:
        """Run the step once on the current stream; returns its outputs."""
        self.replays += 1
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        for m, n in self.launches:
            m.LAUNCHES += n
        return self.outputs

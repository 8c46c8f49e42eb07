"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

Every wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel (built from ``repro_torch/csrc`` at first
use, see ``_build``) or raises. Each kernel module keeps a plain integer
``LAUNCHES``, incremented where the kernel is launched and nowhere else.
A serve step captured as a CUDA graph (``serve.graphs.StepGraph``) runs
the wrappers once, at capture, where their increments count nothing; the
step graph adds each kernel's launches in the step back to ``LAUNCHES``
on every replay, so the counts stay launches on the card.

Training differentiates through rmsnorm, flash attention and the SSD
scan on the card, at every shape their forwards take: with grad enabled
and an input that requires grad, their wrappers run a
``torch.autograd.Function`` whose backward is a kernel too, counted in
the module's ``BACKWARD_LAUNCHES``. A CUDA call that wants a gradient no
kernel gives (the SSD scan's final state) raises ``NotImplementedError``;
there is no fallback to the plain version.
"""

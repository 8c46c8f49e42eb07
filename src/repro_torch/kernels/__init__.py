"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

Every wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel (built from ``repro_torch/csrc`` at first
use, see ``_build``) or raises. Each kernel module keeps a plain integer
``LAUNCHES``, incremented where the kernel is launched and nowhere else.
"""

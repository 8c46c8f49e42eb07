"""RMSNorm: plain PyTorch version + CUDA kernel wrapper.

Counterpart of ``repro/kernels/rmsnorm/{kernel,ref,ops}.py``; the kernel is
``csrc/rmsnorm.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: kernel launches in this process (the wrapper's CUDA path only)
LAUNCHES = 0


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """RMS-normalize the last axis and apply the learned scale, in fp32,
    cast back to ``x.dtype`` (mirror of the JAX ``ref.rmsnorm``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x`` (..., D), ``scale`` (D,) fp32. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global LAUNCHES
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    _build.require_cuda("rmsnorm", x, scale)
    code = _build.dtype_code("rmsnorm", x.dtype)
    d = x.shape[-1]
    vec = 16 // x.element_size()
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale must be fp32 of shape ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if d % vec or x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError(f"rmsnorm: rows and scale must be 16-byte aligned "
                         f"vectors (D={d} a multiple of {vec})")
    out = torch.empty_like(x)
    rows = x.numel() // d
    rc = _build.lib().repro_rmsnorm(
        code, x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
        float(eps), _build.stream_handle(x))
    _build.check(rc, "rmsnorm")
    LAUNCHES += 1
    return out

"""RMSNorm: plain PyTorch version + CUDA kernel wrapper, and its gradient.

Counterpart of ``repro/kernels/rmsnorm/{kernel,ref,ops}.py``; the kernels
are ``csrc/rmsnorm.cu``: the forward, and a backward kernel (no TPU
counterpart) that training on the card differentiates through.

The wrapper's rule: CPU tensors take the plain version, which autograd
differentiates natively. A CUDA call with grad enabled and an input that
requires grad goes through ``_RMSNormFunction`` (the forward kernel, then
the backward kernel); any other CUDA call is the forward launch alone, as
serving makes it. DTensors run each rank's rows through this same rule
(``kernels._shards``): the rows may be sharded, the width and the scale
may not; meta shards (the dry run's) take the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, _shards

#: kernel launches in this process (the wrapper's CUDA path only)
LAUNCHES = 0
#: backward kernel calls (two grids each: the rows, then the dscale sum)
BACKWARD_LAUNCHES = 0
#: columns a thread of the backward owns at most (its row in registers)
BACKWARD_COLS = 32
#: threads of a backward block at most, and so of a row's team
BACKWARD_MAX_THREADS = 512
#: the widest row the backward kernel takes: a team of 512 threads of 32
#: columns each
MAX_BACKWARD_D = BACKWARD_MAX_THREADS * BACKWARD_COLS
#: threads of a backward block at least (several teams a block when rows
#: are narrow)
BACKWARD_MIN_THREADS = 256


def backward_plan(rows: int, d: int, itemsize: int,
                  sms: int = _build.H100_SMS) -> Tuple[int, int, int]:
    """``(tpr, threads, blocks)`` of the backward kernel: ``tpr`` threads a
    row, the fewest warps that hold the row at ``BACKWARD_COLS`` columns a
    thread (a warp up to 1,024 columns); ``threads`` a block, as many
    teams as fit ``BACKWARD_MIN_THREADS`` (one team when wider); and
    ``blocks``, one wave of the card (two blocks an SM of 256 threads, one
    of more), each over a contiguous range of ``ceil(rows / blocks)``
    rows, none empty."""
    vec = 16 // itemsize
    nvec = -(-d // vec)
    tpr = 32 * -(-nvec // (32 * (BACKWARD_COLS // vec)))
    threads = tpr * max(1, BACKWARD_MIN_THREADS // tpr)
    teams = threads // tpr
    per_sm = max(1, 2 * BACKWARD_MIN_THREADS // threads)
    blocks = max(1, min(-(-rows // teams), per_sm * sms))
    per_block = -(-rows // blocks)
    return tpr, threads, -(-rows // per_block)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """RMS-normalize the last axis and apply the learned scale, in fp32,
    cast back to ``x.dtype`` (mirror of the JAX ``ref.rmsnorm``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                           dy: torch.Tensor, eps: float = 1e-5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)`` of ``rmsnorm_plain`` at ``x`` for the output
    gradient ``dy``, written out in fp32: ``dx`` in ``x.dtype``, ``dscale``
    fp32 (the backward kernel's plain version)."""
    xf, gf, sf = x.float(), dy.float(), scale.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    dot = (gf * sf * xf).sum(dim=-1, keepdim=True)
    dx = r * sf * gf - xf * (r * r * r) * dot / x.shape[-1]
    dscale = (gf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale


def _check(x: torch.Tensor, scale: torch.Tensor,
           backward: bool = False) -> int:
    """Validate a CUDA call (of the backward kernel with ``backward``);
    returns the dtype code."""
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
    if backward and d > MAX_BACKWARD_D:
        raise ValueError(f"rmsnorm: no backward kernel for rows of {d} (at "
                         f"most {MAX_BACKWARD_D})")
    return code


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float,
            code: int) -> torch.Tensor:
    global LAUNCHES
    d = x.shape[-1]
    out = torch.empty_like(x)
    rc = _build.lib().repro_rmsnorm(
        code, x.data_ptr(), scale.data_ptr(), out.data_ptr(),
        x.numel() // d, d, float(eps), _build.stream_handle(x))
    _build.check(rc, "rmsnorm")
    LAUNCHES += 1
    return out


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: ``(dx, dscale)`` for CUDA tensors (``dy`` of
    ``x``'s shape and dtype). Each row's rstd is recomputed; ``dscale`` is
    summed over rows by the kernel itself, in a fixed order."""
    global BACKWARD_LAUNCHES
    code = _check(x, scale, backward=True)
    _build.require_cuda("rmsnorm_backward", x, dy)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.data_ptr() % 16:
        raise ValueError(f"rmsnorm_backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype} (or is not 16-byte aligned)")
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dscale.zero_()
    tpr, threads, blocks = backward_plan(
        rows, d, x.element_size(),
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    rc = _build.lib().repro_rmsnorm_backward(
        code, x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), partial.data_ptr(), blocks, threads, tpr, rows, d,
        float(eps), _build.stream_handle(x))
    _build.check(rc, "rmsnorm_backward")
    BACKWARD_LAUNCHES += 1
    return dx, dscale


class _RMSNormFunction(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel."""

    @staticmethod
    def forward(ctx, x, scale, eps, code):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps, code)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x`` (..., D), ``scale`` (D,) fp32. CPU tensors take the plain
    version; CUDA tensors launch the kernel, through the autograd function
    when a gradient is wanted (see the module's docstring)."""
    if _shards.any_dtensor(x, scale):
        return _rmsnorm_shards(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFunction.apply(x, scale, eps,
                                      _check(x, scale, backward=True))
    code = _check(x, scale)
    return _launch(x, scale, eps, code)


def _rmsnorm_shards(x, scale, eps: float):
    """``rmsnorm`` of a DTensor on each rank's rows (any leading dims
    sharded; the width and the scale whole)."""
    name = "rmsnorm"
    if not _shards.any_dtensor(x):
        raise ValueError(f"{name}: a DTensor scale needs DTensor rows")
    _shards.check(name, "x", x, range(x.ndim - 1))
    _shards.same(name, "scale", x, scale, {})
    split = _shards.split_dims(x)
    fn = rmsnorm_plain if _shards.on_meta(x) else rmsnorm
    out = fn(_shards.local(x, split), _shards.local(scale, split), eps)
    return _shards.wrap(out, x, x.shape)

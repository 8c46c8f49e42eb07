"""Mamba-2 SSD chunked scan: plain PyTorch version + CUDA kernel wrapper,
and its gradient.

Counterpart of ``repro/kernels/ssd_scan/{kernel,ref,ops}.py``; the
kernels are ``csrc/ssd_scan.cu``: the forward, and a backward kernel (no
TPU counterpart) that training on the card differentiates through.
Shapes (the reference's):

* x  ``(B, T, H, P)``  per-head inputs, fp32 or bf16
* dt ``(B, T, H)``     fp32 positive step sizes (softplus + bias applied)
* A  ``(H,)``          fp32 negative per-head decay
* Bm ``(B, T, G, N)``  input projections, like x; head ``h`` reads group
  ``h // (H / G)``
* Cm ``(B, T, G, N)``  output projections, like x
* D  ``(H,)``          fp32 skip gain

Returns ``y (B, T, H, P)`` in ``x.dtype`` and, with ``return_state``, the
fp32 final state ``(B, H, P, N)``, as the reference's ``ssd_chunked`` does
(its Pallas kernel drops the state). ``T`` need not be a multiple of
``chunk``: the last chunk is padded with ``dt = 0`` rows, which neither
decay nor add to the state, and their ``y`` is dropped.

DTensors run each rank's shard through this same rule
(``kernels._shards``): batch and heads may be sharded (x, dt, A and D
alike; B and C on their groups alike, or replicated when there is one
group), not the sequence, head_dim or state. Meta shards (the dry run's)
take the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import _build, _shards

#: kernel launches in this process (the wrapper's CUDA path only)
LAUNCHES = 0
#: backward kernel calls (three grids each: the entering states and the
#: state gradients, the chunk gradients, the sums over head-slices and
#: over (batch, chunk))
BACKWARD_LAUNCHES = 0
#: the kernel's instantiations: (head_dim P, state_dim N) of mamba2-370m
#: and zamba2-1.2b, and chunk
SHAPES = ((64, 128), (64, 64))
CHUNK = 64
#: how the bf16 kernel rounds the operands it computes in fp32 before its
#: tensor-core products (see ``_ssd_chunk_parallel_plain``)
KERNEL_ROUNDING = {"scores": "once", "xw": "hilo", "entering": "once"}
#: how the bf16 backward kernel rounds the operands it computes in fp32
#: before its tensor-core products (see ``ssd_scan_backward_plain``)
BACKWARD_ROUNDING = {"xw": "once", "dye": "once", "entering": "once",
                     "dstates": "once", "scores": "once", "dM": "once"}

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _expand_groups(m: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, G, N) → (B, T, H, N) by repeating groups over their heads."""
    return m.repeat_interleave(n_heads // m.shape[2], dim=2)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                   chunk: int = CHUNK, return_state: bool = False) -> Out:
    """The chunked SSD formulation of the reference ``ssd_chunked``, in
    fp32, cast to ``x.dtype`` at the end."""
    B_, T, H, P = x.shape
    nC = -(-T // chunk)
    pad = nC * chunk - T

    def padded(t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((B_, pad) + tuple(t.shape[2:]))],
                          dim=1)
        return t

    xf = padded(x).reshape(B_, nC, chunk, H, P)
    dtf = padded(dt).reshape(B_, nC, chunk, H)
    Bh = padded(_expand_groups(Bm, H)).reshape(B_, nC, chunk, H, -1)
    Ch = padded(_expand_groups(Cm, H)).reshape(B_, nC, chunk, H, -1)
    N = Bh.shape[-1]

    cum = torch.cumsum(dtf * A.float(), dim=2)         # (B, C, Q, H)
    total = cum[:, :, -1, :]                           # (B, C, H)

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j; the exponent
    # is taken only there (above the diagonal it can overflow)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.where(tri, ldiff, ldiff.new_full((), -float("inf"))).exp()
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * L \
        * dtf[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)

    # chunk states, decayed to the chunk end, then the inter-chunk scan
    decay_to_end = torch.exp(total[:, :, None, :] - cum)
    S = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", dtf * decay_to_end, xf, Bh)
    state = x.new_zeros((B_, H, P, N), dtype=torch.float32)
    entering = []
    for c in range(nC):
        entering.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + S[:, c]
    entering = torch.stack(entering, dim=1)            # (B, C, H, P, N)
    y = y + torch.einsum("bcqhn,bchpn->bcqhp",
                         Ch * torch.exp(cum)[..., None], entering)
    y = y.reshape(B_, nC * chunk, H, P)[:, :T] \
        + x.float() * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    return (y, state) if return_state else y


def _round_operand(t: torch.Tensor, how: Optional[str]) -> torch.Tensor:
    """An fp32 operand as a bf16 tensor-core product sees it: unchanged
    (None), rounded to bf16 once ("once"), or as a hi + lo pair of bf16
    values ("hilo": two products into one fp32 accumulator)."""
    if how is None:
        return t
    hi = t.to(torch.bfloat16).float()
    if how == "once":
        return hi
    if how == "hilo":
        return hi + (t - hi).to(torch.bfloat16).float()
    raise ValueError(f"unknown rounding {how!r}")


def _ssd_chunk_parallel_plain(x: torch.Tensor, dt: torch.Tensor,
                              A: torch.Tensor, Bm: torch.Tensor,
                              Cm: torch.Tensor, D: torch.Tensor, *,
                              chunk: int = CHUNK, return_state: bool = False,
                              rounding: Optional[dict] = None) -> Out:
    """The CUDA kernel's decomposition in plain PyTorch, for the tests:
    (1) each chunk's state ``S_c = Xᵀ diag(w) B``, ``w_j = dt_j
    exp(total - cum_j)``; (2) the states passed in order, ``entering_0 =
    0``, ``entering_{c+1} = exp(total_c) entering_c + S_c``; (3) each
    chunk's ``y = (L∘(C Bᵀ)·dt) X + exp(cum) ∘ (C entering_cᵀ) + D x``.

    ``rounding`` maps the operands the kernel computes in fp32 and feeds
    to bf16 tensor-core products ("scores", "xw" for ``diag(w) X``,
    "entering") to how each is rounded (see ``_round_operand``); x, B and
    C enter as they are."""
    r = rounding or {}
    B_, T, H, P = x.shape
    nC = -(-T // chunk)
    pad = nC * chunk - T

    def chunks(t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((B_, pad) + tuple(t.shape[2:]))],
                          dim=1)
        return t.reshape((B_, nC, chunk) + tuple(t.shape[2:]))

    xf, dtf = chunks(x), chunks(dt)
    Bh, Ch = chunks(_expand_groups(Bm, H)), chunks(_expand_groups(Cm, H))
    cum = torch.cumsum(dtf * A.float(), dim=2)         # (B, C, Q, H)
    total = cum[:, :, -1, :]

    # (1) chunk states
    w = dtf * torch.exp(total[:, :, None, :] - cum)
    xw = _round_operand(w[..., None] * xf, r.get("xw"))
    S = torch.einsum("bcqhp,bcqhn->bchpn", xw, Bh)
    # (2) state passing
    state = S.new_zeros((B_, H, P, S.shape[-1]))
    entering = []
    for c in range(nC):
        entering.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] + S[:, c]
    ent = _round_operand(torch.stack(entering, dim=1), r.get("entering"))
    # (3) chunk scan
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.where(tri, ldiff, ldiff.new_full((), -float("inf"))).exp()
    scores = _round_operand(torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * L
                            * dtf[:, :, None, :, :], r.get("scores"))
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xf) \
        + torch.exp(cum)[..., None] \
        * torch.einsum("bcqhn,bchpn->bcqhp", Ch, ent)
    y = y.reshape(B_, nC * chunk, H, P)[:, :T] \
        + x.float() * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    return (y, state) if return_state else y


def ssd_scan_backward_plain(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bm: torch.Tensor,
                            Cm: torch.Tensor, D: torch.Tensor,
                            dy: torch.Tensor,
                            dfinal: Optional[torch.Tensor] = None, *,
                            chunk: int = CHUNK,
                            rounding: Optional[dict] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, dA, dB, dC, dD)`` of ``ssd_scan_plain``'s ``y`` for the
    output gradient ``dy`` and, with ``dfinal``, of its final state
    ``(B, H, P, N)`` for that gradient (fp32; None: the final state
    carries none), in fp32 in the forward's chunk decomposition (the
    backward kernel's plain version): dx, dB and dC in ``x.dtype``, ddt,
    dA and dD fp32. Per chunk c, with ``E_c`` the state entering it:

    1. the output terms: ``dD``, ``dE_c = Σ_i exp(cum_i) dy_i C_iᵀ``,
       ``dC_i += exp(cum_i) E_cᵀ dy_i``, ``dcum_i += dy_i · y_inter_i``;
    2. the reverse state pass: ``G = dfinal`` (or 0); for c from the last
       chunk down, ``dS_c = G``, ``dtotal_c += exp(total_c) ⟨E_c, G⟩``,
       ``G = dE_c + exp(total_c) G``;
    3. the chunk-state terms of ``S_c = Σ_j w_j x_j B_jᵀ``;
    4. the intra-chunk terms of ``scores_ij = (C_i·B_j) L_ij dt_j``, whose
       ``dM`` enters dB and dC summed over each group's heads (C and B are
       the group's);
    5. ``dcum`` (with ``dtotal`` on the chunk's last row) reverse-summed
       into the step sizes' ``da``: ``ddt += da·A``, ``dA = Σ da·dt``;
    6. dB and dC summed over each group's heads.

    ``rounding`` maps the operands the bf16 kernel computes in fp32 and
    feeds to its tensor-core products (``BACKWARD_ROUNDING``: "xw" and
    "dye" of the recomputed states and of dE, "entering" and "dstates",
    the masked "scores", and the group's "dM") to how each is rounded
    (see ``_round_operand``); the sums that feed dcum, ddt and dA are
    taken from the products' fp32 results, never from rounded
    operands."""
    r = rounding or {}
    B_, T, H, P = x.shape
    G = Bm.shape[2]
    nC = -(-T // chunk)
    pad = nC * chunk - T

    def chunks(t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((B_, pad) + tuple(t.shape[2:]))],
                          dim=1)
        return t.reshape((B_, nC, chunk) + tuple(t.shape[2:]))

    def group_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
        """(..., H, ...) at ``dim`` → (..., G, ...): each group's heads."""
        shape = t.shape[:dim] + (G, H // G) + t.shape[dim + 1:]
        return t.reshape(shape).sum(dim=dim + 1)

    xf, dtf, gy = chunks(x), chunks(dt), chunks(dy)
    Bg, Cg = chunks(Bm), chunks(Cm)                    # (B, C, Q, G, N)
    Bh, Ch = chunks(_expand_groups(Bm, H)), chunks(_expand_groups(Cm, H))
    N = Bh.shape[-1]
    a = A.float()
    cum = torch.cumsum(dtf * a, dim=2)                 # (B, C, Q, H)
    total = cum[:, :, -1, :]                           # (B, C, H)
    decay = torch.exp(total)
    to_end = torch.exp(total[:, :, None, :] - cum)
    w = dtf * to_end
    ecum = torch.exp(cum)
    xw = _round_operand(w[..., None] * xf, r.get("xw"))
    S = torch.einsum("bcqhp,bcqhn->bchpn", xw, Bh)
    state = S.new_zeros((B_, H, P, N))
    entering = []
    for c in range(nC):
        entering.append(state)
        state = state * decay[:, c, :, None, None] + S[:, c]
    E = torch.stack(entering, dim=1)                   # (B, C, H, P, N)

    # 1. output terms
    dD = (gy * xf).sum(dim=(0, 1, 2, 4))
    dye = _round_operand(ecum[..., None] * gy, r.get("dye"))
    dE = torch.einsum("bcqhp,bcqhn->bchpn", dye, Ch)
    dC = ecum[..., None] * torch.einsum(
        "bchpn,bcqhp->bcqhn", _round_operand(E, r.get("entering")), gy)
    dcum = (Ch * dC).sum(dim=-1)                       # dy_i · y_inter_i
    # 2. reverse state pass
    dtotal = torch.zeros_like(total)
    g = S.new_zeros((B_, H, P, N)) if dfinal is None else dfinal.float()
    dS = [g] * nC
    for c in reversed(range(nC)):
        dS[c] = g
        dtotal[:, c] = decay[:, c] * (E[:, c] * g).sum(dim=(-2, -1))
        g = dE[:, c] + decay[:, c, :, None, None] * g
    dS = _round_operand(torch.stack(dS, dim=1), r.get("dstates"))
    # 3. chunk-state terms
    dSB = torch.einsum("bchpn,bcqhn->bcqhp", dS, Bh)
    dx = w[..., None] * dSB
    dB = w[..., None] * torch.einsum("bchpn,bcqhp->bcqhn", dS, xf)
    dw = (xf * dSB).sum(dim=-1)                        # (B, C, Q, H)
    ddt = dw * to_end
    dtotal = dtotal + (dw * w).sum(dim=2)
    dcum = dcum - dw * w
    # 4. intra-chunk terms; the exponent only where i >= j
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.where(tri, ldiff, ldiff.new_full((), -float("inf"))).exp()
    M = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * L
    scores = _round_operand(M * dtf[:, :, None, :, :], r.get("scores"))
    dscores = torch.einsum("bcihp,bcjhp->bcijh", gy, xf)
    dx = dx + torch.einsum("bcijh,bcihp->bcjhp", scores, gy)
    dM = _round_operand(group_sum(dscores * L * dtf[:, :, None, :, :], 4),
                        r.get("dM"))                   # (B, C, Q, Q, G)
    t = dscores * M
    col = t.sum(dim=2)                                 # over i: (B, C, Q, H)
    ddt = ddt + col
    dcum = dcum + (t * dtf[:, :, None, :, :]).sum(dim=3) - dtf * col
    # 5. dcum (total is the last row's cum) into the step sizes
    dcum[:, :, -1, :] += dtotal
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = ddt + da * a
    dA = (da * dtf).sum(dim=(0, 1, 2))
    dx = dx + gy * D.float()[None, None, None, :, None]

    # 6. back to (B, T, ...), each group's heads summed
    def rows(t: torch.Tensor) -> torch.Tensor:
        return t.reshape((B_, nC * chunk) + tuple(t.shape[3:]))[:, :T]

    dB = group_sum(dB, 3) + torch.einsum("bcijg,bcign->bcjgn", dM, Cg)
    dC = group_sum(dC, 3) + torch.einsum("bcijg,bcjgn->bcign", dM, Bg)
    return (rows(dx).to(x.dtype), rows(ddt), dA, rows(dB).to(x.dtype),
            rows(dC).to(x.dtype), dD)


def scratch_floats(B: int, T: int, H: int, P: int, N: int) -> int:
    """fp32 scratch of one kernel call: the (B, nC, H, P, N) chunk states
    and the (B, nC, H) chunk decays."""
    return B * -(-T // CHUNK) * H * (P * N + 1)


def backward_head_splits(B: int, T: int, H: int, G: int,
                         sms: int = _build.H100_SMS) -> int:
    """k, the head-slices each group's heads are cut into for the backward
    kernel's chunk grid (one block a (group, slice, batch, chunk)): the
    smallest divisor of ``H // G`` whose ``G * k * B * nC`` blocks make two
    waves of ``sms``, or every head a slice of its own when none does."""
    per = H // G
    blocks = G * B * -(-T // CHUNK)
    for k in range(1, per + 1):
        if per % k == 0 and k * blocks >= 2 * sms:
            return k
    return per


def backward_scratch_floats(B: int, T: int, H: int, G: int, P: int, N: int,
                            splits: int) -> int:
    """fp32 scratch of one backward call: the recomputed entering states
    and the state gradients (B, nC, H, P, N) each, the per-chunk dA and dD
    terms (B, nC, H) each, and, when a group is cut into ``splits`` > 1
    head-slices, each slice's dB and dC rows (B, T, G, splits, N) each."""
    nC = -(-T // CHUNK)
    return B * nC * H * (2 * P * N + 2) \
        + (2 * B * T * G * splits * N if splits > 1 else 0)


def _check(x, dt, A, Bm, Cm, D, chunk: int) -> int:
    """Validate a CUDA call; returns the dtype code."""
    _build.require_cuda("ssd_scan", x, dt, A, Bm, Cm, D)
    code = _build.dtype_code("ssd_scan", x.dtype)
    B_, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (P, N) not in SHAPES or chunk != CHUNK:
        raise ValueError(f"ssd_scan: no kernel for head_dim {P}, state_dim "
                         f"{N}, chunk {chunk}; instantiated: {SHAPES} at "
                         f"chunk {CHUNK}")
    if H % G or Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (B_, T):
        raise ValueError(f"ssd_scan: B/C {tuple(Bm.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("ssd_scan: B and C must have x's dtype")
    if tuple(dt.shape) != (B_, T, H) or any(
            t.dtype != torch.float32 or tuple(t.shape) != (H,)
            for t in (A, D)) or dt.dtype != torch.float32:
        raise ValueError("ssd_scan: dt (B, T, H), A and D (H,) must be "
                         "fp32")
    if any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan: x, B and C must be 16-byte aligned")
    return code


def _launch(x, dt, A, Bm, Cm, D, code: int, return_state: bool) -> Out:
    """The forward kernel on validated CUDA tensors."""
    global LAUNCHES
    B_, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    final: Optional[torch.Tensor] = None
    if return_state:
        final = torch.empty((B_, H, P, N), dtype=torch.float32,
                            device=x.device)
    # the chunk states, overwritten in place by the entering states, and
    # exp(total) of each chunk; sized from the shapes alone (no host read)
    scratch = torch.empty(scratch_floats(B_, T, H, P, N),
                          dtype=torch.float32, device=x.device)
    rc = _build.lib().repro_ssd_scan(
        code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr(), y.data_ptr(),
        final.data_ptr() if final is not None else None, scratch.data_ptr(),
        B_, T, H, G, P, N, _build.stream_handle(x))
    _build.check(rc, "ssd_scan")
    LAUNCHES += 1
    return (y, final) if return_state else y


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                      dy: torch.Tensor,
                      dfinal: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel: ``(dx, ddt, dA, dB, dC, dD)`` for CUDA tensors
    (``dy`` of x's shape and dtype; ``dfinal``, the final state's gradient,
    fp32 (B, H, P, N) or None), as ``ssd_scan_backward_plain`` computes
    them. It recomputes the entering states rather than keeping them from
    the forward."""
    global BACKWARD_LAUNCHES
    code = _check(x, dt, A, Bm, Cm, D, CHUNK)
    _build.require_cuda("ssd_scan_backward", x, dy)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.data_ptr() % 16:
        raise ValueError(f"ssd_scan_backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype} (or is not 16-byte aligned)")
    B_, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dfinal is not None:
        _build.require_cuda("ssd_scan_backward", x, dfinal)
        if tuple(dfinal.shape) != (B_, H, P, N) \
                or dfinal.dtype != torch.float32 or dfinal.data_ptr() % 16:
            raise ValueError(f"ssd_scan_backward: dfinal must be fp32 "
                             f"{(B_, H, P, N)}, 16-byte aligned")
    splits = backward_head_splits(
        B_, T, H, G,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    dx, dB, dC = (torch.empty_like(t) for t in (x, Bm, Cm))
    ddt = torch.empty_like(dt)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    scratch = torch.empty(
        backward_scratch_floats(B_, T, H, G, P, N, splits),
        dtype=torch.float32, device=x.device)
    rc = _build.lib().repro_ssd_scan_backward(
        code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr(), dy.data_ptr(),
        dfinal.data_ptr() if dfinal is not None else None, dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dD.data_ptr(), scratch.data_ptr(), B_, T, H, G, P, N, splits,
        _build.stream_handle(x))
    _build.check(rc, "ssd_scan_backward")
    BACKWARD_LAUNCHES += 1
    return dx, ddt, dA, dB, dC, dD


class _SSDFunction(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel (through
    the final state too when it is returned)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, code, return_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.set_materialize_grads(False)
        return _launch(x, dt, A, Bm, Cm, D, code, return_state)

    @staticmethod
    def backward(ctx, dy, dfinal=None):
        # saved_tensors read once: checkpointing (remat) allows one unpack
        saved = ctx.saved_tensors
        dy = torch.zeros_like(saved[0]) if dy is None else dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.float().contiguous()
        return ssd_scan_backward(*saved, dy, dfinal) + (None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int = CHUNK, return_state: bool = False) -> Out:
    """CPU tensors take the plain version, which autograd differentiates;
    CUDA tensors launch the kernel: three grids per call (chunk states,
    state passing, chunk scan; see ``_ssd_chunk_parallel_plain``), counted
    as one launch. With grad enabled and an input that requires grad, a
    CUDA call goes through ``_SSDFunction``: the backward kernel
    differentiates y and, with ``return_state``, the final state."""
    if _shards.any_dtensor(x, dt, A, Bm, Cm, D):
        return _ssd_shards(x, dt, A, Bm, Cm, D, chunk=chunk,
                           return_state=return_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=chunk,
                              return_state=return_state)
    code = _check(x, dt, A, Bm, Cm, D, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, D)):
        return _SSDFunction.apply(x, dt, A, Bm, Cm, D, code, return_state)
    return _launch(x, dt, A, Bm, Cm, D, code, return_state)


def _ssd_shards(x, dt, A, Bm, Cm, D, *, chunk: int,
                return_state: bool) -> Out:
    """``ssd_scan`` of DTensors on each rank's batch rows and heads; the
    final state ``(B, H, P, N)`` is placed as x's batch and heads."""
    name = "ssd_scan"
    if not _shards.any_dtensor(x):
        raise ValueError(f"{name}: DTensor operands need a DTensor x")
    _shards.check(name, "x", x, (0, 2))
    _shards.same(name, "dt", x, dt, {0: 0, 2: 2})
    for what, t in (("A", A), ("D", D)):
        _shards.same(name, what, x, t, {2: 0})
    G = Bm.shape[2]
    # one group: B and C replicated over the heads' mesh dims; else their
    # groups split as the heads do
    groups = {0: 0} if G == 1 else {0: 0, 2: 2}
    for what, t in (("B", Bm), ("C", Cm)):
        _shards.same(name, what, x, t, groups)
    _shards.divides(name, x, 2, (x.shape[2],) + ((G,) if G > 1 else ()))
    split = _shards.split_dims(x, dt, Bm, Cm)
    fn = ssd_scan_plain if _shards.on_meta(x) else ssd_scan
    out = fn(*(_shards.local(t, split) for t in (x, dt, A, Bm, Cm, D)),
             chunk=chunk, return_state=return_state)
    y, final = out if return_state else (out, None)
    y = _shards.wrap(y, x, x.shape)
    if not return_state:
        return y
    B_, _, H, P = x.shape
    return y, _shards.wrap(final, x, (B_, H, P, Bm.shape[3]),
                           _shards.remap(x, {0: 0, 2: 1}))

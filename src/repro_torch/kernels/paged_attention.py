"""Fused paged attention over one layer's KV page pool: plain PyTorch
version + CUDA kernel wrapper.

Counterpart of ``repro/kernels/paged_attention/{kernel,ref,ops}.py``; the
kernel is ``csrc/paged_attention.cu``: a split kernel over position
ranges of ``SPLIT_LEN`` and a merge kernel, two CUDA launches per call
(``LAUNCHES`` counts calls). The pool layout is the reference's
contract:

* pool (one layer): ``(total_pages + 1, page_size, KV, head_dim)``; index
  ``total_pages`` is the scratch ("null") page that table padding names;
* ``tables (S, T)`` int32: entry ``p`` of a slot's row is the page holding
  absolute positions ``[p*page_size, (p+1)*page_size)``;
* ``positions (S,)`` int32: absolute position of window row 0 per slot;
* ``n_valid (S,)`` int32: window rows written per slot (0 = idle slot).

Both versions update the pool in place and store only the window rows
``j < n_valid``: rows past ``n_valid`` are written nowhere, not even on the
null page (the JAX reference parks them there; compare pools on real pages
only).

DTensors run each rank's shard through this same rule
(``kernels._shards``): the heads may be sharded (q, the new rows and the
pools alike, whole KV groups a rank), nothing else; the page index is
replicated. Meta shards take the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _shards

#: kernel launches in this process (the wrapper's CUDA path only)
LAUNCHES = 0
HEAD_DIMS = (64, 128)    # the kernels' instantiations (ported configs)
#: positions per split of the kernel (``kSplit`` in the .cu, which refuses
#: any other value)
SPLIT_LEN = 64


def paged_attention_plain(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, tables: torch.Tensor,
                          positions: torch.Tensor, n_valid: torch.Tensor, *,
                          page_size: int, scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mirror of the JAX ``ref.paged_attention``: scatter the valid new
    rows, gather each slot's contiguous view, grouped-einsum attention
    with the same ``-1e30`` mask, ``qpos`` clamp and ``alive`` zeroing.

    q: (S, W, H, hd); k_new/v_new: (S, W, KV, hd); pools (P+1, ps, KV, hd)
    updated in place. Returns ``(out (S, W, H, hd), k_pages, v_pages)``.
    """
    S, W, H, hd = q.shape
    P1, ps, KV, _ = k_pages.shape
    T = tables.shape[1]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    dev = q.device
    tables = tables.long()
    positions = positions.long()
    n_valid = n_valid.long()

    offs = torch.arange(W, device=dev)
    pos_j = positions[:, None] + offs[None, :]                  # (S, W)
    entry = (pos_j // ps).clamp(0, T - 1)
    page = torch.gather(tables, 1, entry)
    valid = offs[None, :] < n_valid[:, None]
    rows = (page * ps + pos_j % ps)[valid]
    k_pages.view(P1 * ps, KV, hd)[rows] = k_new[valid]
    v_pages.view(P1 * ps, KV, hd)[rows] = v_new[valid]

    gk = k_pages[tables].reshape(S, T * ps, KV, hd)
    gv = v_pages[tables].reshape(S, T * ps, KV, hd)
    qg = q.reshape(S, W, KV, G, hd)
    scores = torch.einsum("swkgd,stkd->skgwt", qg, gk).float() * scale
    idx = torch.arange(T * ps, device=dev)
    qpos = torch.where(
        n_valid[:, None] > 0,
        positions[:, None] + torch.minimum(offs[None, :], n_valid[:, None] - 1),
        torch.full_like(pos_j, -1))
    mask = idx[None, None, :] <= qpos[:, :, None]               # (S, W, T*ps)
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    alive = mask.any(dim=-1)                                    # (S, W)
    probs = probs * alive[:, None, None, :, None].to(probs.dtype)
    o = torch.einsum("skgwt,stkd->swkgd", probs, gv)
    return o.reshape(S, W, H, hd), k_pages, v_pages


def _paged_split_merge_plain(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, tables: torch.Tensor,
                             positions: torch.Tensor, n_valid: torch.Tensor,
                             *, page_size: int, split_len: int = SPLIT_LEN,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel's partition in plain fp32 PyTorch, for the tests:
    window rows ``j < n_valid`` read from ``k_new``/``v_new`` (the pools
    are not written), each range of ``split_len`` positions reduced to its
    own ``(m, l, acc)``, a split with no visible key to ``(-1e30, 0, 0)``,
    then merged by rescaling with ``exp(m - max m)``; a row with no live
    split is 0. Returns ``out (S, W, H, hd)`` in fp32."""
    S, W, H, hd = q.shape
    ps, KV = k_pages.shape[1], k_pages.shape[2]
    T = tables.shape[1]
    G = H // KV
    n_pos = T * ps
    scale = hd ** -0.5 if scale is None else scale
    f32, dev = torch.float32, q.device
    pos = positions.long()
    nv = n_valid.long().clamp(max=W)
    gk = k_pages[tables.long()].reshape(S, n_pos, KV, hd).float()
    gv = v_pages[tables.long()].reshape(S, n_pos, KV, hd).float()
    idx = torch.arange(n_pos, device=dev)
    jj = idx[None, :] - pos[:, None]                          # (S, n_pos)
    window = ((jj >= 0) & (jj < nv[:, None]))[:, :, None, None]
    at = jj.clamp(0, W - 1)[:, :, None, None].expand(S, n_pos, KV, hd)
    gk = torch.where(window, torch.gather(k_new.float(), 1, at), gk)
    gv = torch.where(window, torch.gather(v_new.float(), 1, at), gv)
    offs = torch.arange(W, device=dev)
    qpos = pos[:, None] + torch.minimum(offs[None, :], nv[:, None] - 1)
    visible = (idx[None, None, :] <= qpos[:, :, None]) \
        & (nv[:, None, None] > 0)                             # (S, W, n_pos)
    scores = torch.einsum("swkgd,stkd->swkgt",
                          q.reshape(S, W, KV, G, hd).to(f32), gk) * scale
    scores = scores.masked_fill(~visible[:, :, None, None, :], -1e30)
    ms, ls, accs = [], [], []
    for lo in range(0, n_pos, split_len):
        sc = scores[..., lo:lo + split_len]
        m = sc.max(dim=-1).values
        dead = m <= -1e30
        p = torch.where(dead[..., None], torch.zeros_like(sc),
                        torch.exp(sc - m[..., None]))
        ms.append(torch.where(dead, torch.full_like(m, -1e30), m))
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("swkgt,stkd->swkgd", p,
                                 gv[:, lo:lo + split_len]))
    m = torch.stack(ms)
    w = torch.where(m <= -1e30, torch.zeros_like(m),
                    torch.exp(m - m.max(dim=0).values))
    l = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    return (acc / l.clamp_min(1e-30)[..., None]).reshape(S, W, H, hd)


def paged_attention(q: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, tables: torch.Tensor,
                    positions: torch.Tensor, n_valid: torch.Tensor, *,
                    page_size: int, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CPU tensors take the plain version; CUDA tensors launch the kernel.
    Returns ``(out, k_pages, v_pages)``, the pools updated in place."""
    global LAUNCHES
    if _shards.any_dtensor(q, k_new, v_new, k_pages, v_pages, tables,
                           positions, n_valid):
        return _paged_shards(q, k_new, v_new, k_pages, v_pages, tables,
                             positions, n_valid, page_size=page_size,
                             scale=scale)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_new, v_new, k_pages, v_pages,
                                     tables, positions, n_valid,
                                     page_size=page_size, scale=scale)
    name = "paged_attention"
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_new, v_new, k_pages, v_pages)):
        raise NotImplementedError(
            "paged_attention: serving only, no backward kernel")
    _build.require_cuda(name, q, k_new, v_new, k_pages, v_pages, tables,
                        positions, n_valid)
    code = _build.dtype_code(name, q.dtype)
    S, W, H, hd = q.shape
    P1, ps, KV, _ = k_pages.shape
    T = tables.shape[1]
    if ps != page_size:
        raise ValueError(f"{name}: pool page size {ps} != {page_size}")
    if (k_new.shape != (S, W, KV, hd) or v_new.shape != k_new.shape
            or k_pages.shape != (P1, ps, KV, hd)
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k_new "
                         f"{tuple(k_new.shape)} pages {tuple(k_pages.shape)} "
                         "do not fit together")
    if tables.shape != (S, T) or positions.shape != (S,) \
            or n_valid.shape != (S,):
        raise ValueError(f"{name}: tables (S, T), positions (S,) and "
                         f"n_valid (S,) expected for S={S}")
    for t in (k_new, v_new, k_pages, v_pages):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: all K/V tensors must be {q.dtype}")
    for t in (tables, positions, n_valid):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: tables/positions/n_valid must be int32")
    if H % KV or hd not in HEAD_DIMS:
        raise ValueError(f"{name}: needs H % KV == 0 and hd in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k_new, v_new, k_pages, v_pages)):
        raise ValueError(f"{name}: q/K/V must be 16-byte aligned")
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    # the split count comes from host-known sizes only (no device read):
    # each split leaves (acc[hd], m, l) per output row in fp32
    n_split = -(-(T * ps) // SPLIT_LEN)
    partials = torch.empty(n_split * S * W * H * (hd + 2),
                           dtype=torch.float32, device=q.device)
    rc = _build.lib().repro_paged_attention(
        code, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        positions.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
        partials.data_ptr(), S, W, H, KV, hd, ps, T, SPLIT_LEN,
        float(scale), _build.stream_handle(q))
    _build.check(rc, name)
    LAUNCHES += 1
    return out, k_pages, v_pages


def _paged_shards(q, k_new, v_new, k_pages, v_pages, tables, positions,
                  n_valid, **kw):
    """``paged_attention`` of DTensors on each rank's heads: q, the new
    rows and both pools sharded alike on their head dim (2), the page
    index replicated; the pools are updated in place on every rank."""
    name = "paged_attention"
    if not _shards.any_dtensor(q):
        raise ValueError(f"{name}: DTensor K/V need a DTensor q")
    _shards.check(name, "q", q, (2,))
    for what, t in (("k_new", k_new), ("v_new", v_new),
                    ("k_pages", k_pages), ("v_pages", v_pages)):
        _shards.same(name, what, q, t, {2: 2})
    for what, t in (("tables", tables), ("positions", positions),
                    ("n_valid", n_valid)):
        _shards.same(name, what, q, t, {})
    _shards.divides(name, q, 2, (q.shape[2], k_new.shape[2]))
    split = _shards.split_dims(q)
    args = [_shards.local(t, split) for t in (
        q, k_new, v_new, k_pages, v_pages, tables, positions, n_valid)]
    fn = paged_attention_plain if _shards.on_meta(q) else paged_attention
    out, _, _ = fn(*args, **kw)
    return _shards.wrap(out, q, q.shape), k_pages, v_pages

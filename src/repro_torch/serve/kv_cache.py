"""Paged KV-cache block pool with prefix reuse.

Counterpart of ``repro/serve/kv_cache.py``: the same host bookkeeping
(free list, refcounts, content-hashed prefix index, null scratch page) and
the same device layout, one allocation per K and V of ``(n_layers,
total_pages + 1, page_size, kv_heads, head_dim)`` with index
``total_pages`` as the scratch ("null") page that table padding names.

* **free-list allocation** — worst case at admission (``ceil((prompt +
  max_new) / page_size)`` pages), so decode never allocates mid-flight;
  capacity-deferred requests go back to the head of the batcher queue.
* **prefix reuse** — full prompt pages are keyed by chained sha256
  digests of the token prefix (byte-identical to the reference's: the
  multi-replica router gossips them). A request whose prompt starts with
  a resident prefix maps those pages read-only and skips re-prefilling
  them; every write lands in pages the request owns.

All mutation happens on the engine loop thread; the device arrays are
updated in place by the serving steps on one stream, and by
``import_page`` (disaggregated serving: pages shipped from a prefill
role's pool with ``export_page``). Those two are the counterparts of the
reference's ``_page_slice`` and ``_page_install``; ``write_table`` builds
the unfused verify step's scatter targets on the host.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, FrozenSet, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.common import DENSE, MOE, ModelConfig
from repro_torch.util import resolve_device


def prefix_keys(tokens: Any, page_size: int,
                n_pages: Optional[int] = None) -> List[bytes]:
    """Chained per-page prefix digests of a token sequence: key ``i``
    hashes the first ``(i+1) * page_size`` tokens (as int32 bytes) with
    one running sha256. ``n_pages`` defaults to every full page."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    if n_pages is None:
        n_pages = len(toks) // int(page_size)
    keys: List[bytes] = []
    h = hashlib.sha256()
    for i in range(n_pages):
        h.update(toks[i * page_size:(i + 1) * page_size].tobytes())
        keys.append(h.digest())
    return keys


def paged_supported(cfg: ModelConfig) -> bool:
    """Paged caching targets stacked full-attention KV caches: dense/MoE
    decoders with ``scan_layers`` and no sliding window."""
    return (cfg.family in (DENSE, MOE) and cfg.scan_layers
            and not cfg.window)


def pages_for(n_tokens: int, page_size: int) -> int:
    return -(-int(n_tokens) // int(page_size))


class PagePool:
    """Fixed-size KV page pool: free-list + refcounts + prefix index.

    The device tensors live in ``arrays`` (``{"k", "v"}``, page axis 1)
    and are created lazily on ``device``, so constructing an engine
    allocates nothing on the card. This object owns only the host-side
    bookkeeping.
    """

    def __init__(self, cfg: ModelConfig, total_pages: int, page_size: int,
                 device: Any = "cuda") -> None:
        if not paged_supported(cfg):
            raise ValueError(
                f"paged KV cache unsupported for family={cfg.family!r} "
                f"(scan_layers={cfg.scan_layers}, window={cfg.window})")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.total_pages = int(total_pages)
        self.page_size = int(page_size)
        self.null_page = self.total_pages      # scratch page, never owned
        self._free: List[int] = list(range(self.total_pages))
        self._ref = np.zeros(self.total_pages, np.int32)
        # prefix index: digest of the prompt's first (i+1)*page_size
        # tokens -> resident page holding page i of that prefix
        self._prefix: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self.arrays: Optional[Dict[str, torch.Tensor]] = None
        self.stats = {"allocated": 0, "released": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0, "peak_in_use": 0,
                      "pages_exported": 0, "pages_imported": 0}

    # ------------------------------------------------------------- arrays
    def ensure_arrays(self) -> None:
        if self.arrays is not None:
            return
        cfg = self.cfg
        shape = (cfg.n_layers, self.total_pages + 1, self.page_size,
                 cfg.padded_kv_heads, cfg.resolved_head_dim)
        self.arrays = {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device)}

    @property
    def page_nbytes(self) -> int:
        """Wire size of one exported page (all layers, k + v)."""
        cfg = self.cfg
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        return (2 * cfg.n_layers * self.page_size * cfg.padded_kv_heads
                * cfg.resolved_head_dim * itemsize)

    # ------------------------------------------------- remote page shipping
    def export_page(self, page: int) -> Dict[str, torch.Tensor]:
        """Copy one resident page out of the pool: ``{"k", "v"}`` fresh
        contiguous tensors of shape ``(n_layers, page_size, kv_heads,
        head_dim)``, queued on the current stream behind every write
        already queued there against the pool. A prefill role can ship
        them over a transport, and later release or overwrite the page,
        without waiting for the copy."""
        self.ensure_arrays()
        self.stats["pages_exported"] += 1
        return {k: a[:, page].clone(memory_format=torch.contiguous_format)
                for k, a in self.arrays.items()}

    def import_page(self, page: int, data: Dict[str, torch.Tensor]) -> None:
        """Install shipped KV into an owned page (the ingestion side of
        ``export_page``): an in-place copy queued on the current stream.
        The pool's tensors are never rebound, so step graphs captured over
        them read the page, and any step queued later on the same stream
        runs after the copy."""
        self.ensure_arrays()
        for k, a in self.arrays.items():
            a[:, page].copy_(data[k])
        self.stats["pages_imported"] += 1

    # ---------------------------------------------------------- free list
    @property
    def pages_in_use(self) -> int:
        return self.total_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages (refcount 1 each), or None if the pool can't
        cover them — the caller defers the request, never partial-allocs."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.stats["allocated"] += n
        self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                        self.pages_in_use)
        return pages

    def retain(self, page: int) -> None:
        if self._ref[page] <= 0:
            raise RuntimeError(f"retain of free page {page}")
        self._ref[page] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; refcount-0 pages return to the
        free list and fall out of the prefix index."""
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                key = self._page_key.pop(p, None)
                if key is not None:
                    self._prefix.pop(key, None)
                self._free.append(p)
                self.stats["released"] += 1

    # ------------------------------------------------- speculative writes
    def write_table(self, page_ids: Sequence[int], pos: int,
                    width: int) -> np.ndarray:
        """Scatter targets of an unfused verify step whose write window
        starts at ``pos`` and spans ``width`` pages (``1 + ceil(K /
        page_size)`` for K drafts): entry ``j`` is the page holding
        positions from ``(pos // page_size + j) * page_size``, or the
        scratch page past the request's reserved footprint.

        The window may reach up to K positions past the token budget (the
        padded drafts of a nearly finished request); nulling those entries
        sends that KV to the scratch page, so a rejected tail never lands
        in a real page. Rejected writes inside the footprint are rolled
        back by position: the engine advances ``pos`` only by the accepted
        run, and the next window overwrites them before the causal mask
        reaches them."""
        out = np.full(width, self.null_page, np.int32)
        first = int(pos) // self.page_size
        for j in range(width):
            if first + j < len(page_ids):
                out[j] = page_ids[first + j]
        return out

    # -------------------------------------------------------- prefix reuse
    def prefix_keys(self, tokens: Any,
                    n_pages: Optional[int] = None) -> List[bytes]:
        """Chained per-page prefix digests at this pool's ``page_size``."""
        return prefix_keys(tokens, self.page_size, n_pages)

    def match_prefix(self, prompt: Any) -> List[int]:
        """Longest chain of resident pages covering a page-aligned prompt
        prefix, capped at ``len(prompt) - 1`` tokens so the last prompt
        token is always re-run (its logits give the first token). Does NOT
        retain."""
        n = (len(np.asarray(prompt).reshape(-1)) - 1) // self.page_size
        matched: List[int] = []
        for key in self.prefix_keys(prompt, n):
            page = self._prefix.get(key)
            if page is None:
                break
            matched.append(page)
        return matched

    def resident_prefix_len(self, tokens: Any) -> int:
        """Leading tokens of ``tokens`` covered by resident shared pages."""
        return len(self.match_prefix(tokens)) * self.page_size

    def prefix_digests(self) -> FrozenSet[bytes]:
        """Snapshot of every resident prefix digest."""
        return frozenset(self._prefix)

    def register_prefix(self, prompt: Any, table: Sequence[int]) -> None:
        """Index every full prompt page of ``table`` for future sharing
        (first registration wins)."""
        n = len(np.asarray(prompt).reshape(-1)) // self.page_size
        for i, key in enumerate(self.prefix_keys(prompt, n)):
            if key not in self._prefix:
                self._prefix[key] = table[i]
                self._page_key[table[i]] = key

    def metrics(self) -> Dict[str, Any]:
        out = dict(self.stats)
        out["pages_in_use"] = self.pages_in_use
        out["total_pages"] = self.total_pages
        out["page_size"] = self.page_size
        return out

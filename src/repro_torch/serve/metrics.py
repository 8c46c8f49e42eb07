"""Typed serving metrics — one shape for every engine tier.

``ServeEngine``, ``DisaggServer`` and the multi-replica ``Router`` all
report the same headline metrics, but the key names had drifted (the
prefill role prefixed its pool counters ``pool_*``; the facade nested
what the engine flattened). ``ServeMetrics`` is the unification: a typed
dataclass carrying the headline fields every tier shares, plus an
``extra`` mapping for tier-specific counters, exposed as a read-only
``Mapping`` so every existing ``metrics()["key"]`` consumer keeps
working unchanged.

Back-compat: ``as_dict()`` returns the old plain-dict shape, and legacy
key aliases (``pool_pages_in_use`` → ``pages_in_use``, …) still resolve
through ``__getitem__``/``get`` — with a ``DeprecationWarning`` so the
drifted spellings can eventually be dropped.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Mapping
from typing import Any, Dict, Iterator

# drifted spelling -> canonical key. The ``pool_*`` family (the prefill
# role used to prefix every PagePool counter) is handled structurally in
# ``_canonical`` so new pool counters don't need enumeration here.
LEGACY_ALIASES: Dict[str, str] = {
    "pool_pages_in_use": "pages_in_use",
    "pool_total_pages": "total_pages",
    "pool_page_size": "page_size",
}

# dataclass fields every tier reports (``extra`` carries the rest).
# The ``transport_*`` family is zero for tiers without a transport
# (colocated ``ServeEngine``); transport-connected tiers fill them via
# ``transport_fields`` from their ``Transport.stats()`` per-tag counters.
_TYPED_FIELDS = ("finished", "total_tokens", "ttft_mean", "ttft_p50",
                 "ttft_p99", "accept_rate", "retired", "pages_in_use",
                 "total_pages", "transport_sent_msgs",
                 "transport_recvd_msgs", "transport_sent_bytes",
                 "transport_recvd_bytes", "transport_ctrl_bytes",
                 "transport_data_bytes")

# data-plane tags (per-request KV-block channels) start here; everything
# below is control plane (headers, routing, gossip, heartbeats)
_DATA_TAG_BASE = 1 << 16


def transport_fields(stats: Dict[str, Any]) -> Dict[str, Any]:
    """Lift a ``Transport.stats()`` snapshot into the typed
    ``transport_*`` metric fields.

    Message counts sum delivered traffic per tag; the byte split
    classifies tags into control plane (< ``1 << 16``: headers, routing,
    gossip, heartbeats) vs data plane (per-request KV-block channels),
    so dashboards separate shipping bandwidth from control chatter
    without parsing the nested per-tag dict.
    """
    sent_msgs = recvd_msgs = 0
    ctrl = data = 0
    for tag, t in stats.get("per_tag", {}).items():
        sent_msgs += t.get("sent_msgs", 0)
        recvd_msgs += t.get("recvd_msgs", 0)
        b = t.get("sent_bytes", 0)
        if int(tag) >= _DATA_TAG_BASE:
            data += b
        else:
            ctrl += b
    return {
        "transport_sent_msgs": sent_msgs,
        "transport_recvd_msgs": recvd_msgs,
        "transport_sent_bytes": stats.get("sent_bytes", 0),
        "transport_recvd_bytes": stats.get("recvd_bytes", 0),
        "transport_ctrl_bytes": ctrl,
        "transport_data_bytes": data,
    }


@dataclasses.dataclass(frozen=True)
class ServeMetrics(Mapping):
    """Headline serving metrics shared by every engine tier.

    * throughput/latency over finished requests (``summarize``):
      ``finished``, ``total_tokens``, ``ttft_mean``/``p50``/``p99``,
      ``accept_rate``;
    * lifecycle: ``retired``;
    * KV residency (the leak-check pair): ``pages_in_use``,
      ``total_pages``;
    * transport traffic (zero for colocated tiers): ``transport_*``
      message/byte counters with a control-vs-data-plane byte split.

    Everything tier-specific (step counters, ingest stats, nested role
    metrics, transport stats, …) lives in ``extra`` and is reachable
    through the same ``Mapping`` interface — ``metrics()["steps"]``
    works whether the key is typed or extra.
    """

    finished: int = 0
    total_tokens: int = 0
    ttft_mean: float = 0.0
    ttft_p50: float = 0.0
    ttft_p99: float = 0.0
    accept_rate: float = 0.0
    retired: int = 0
    pages_in_use: int = 0
    total_pages: int = 0
    transport_sent_msgs: int = 0
    transport_recvd_msgs: int = 0
    transport_sent_bytes: int = 0
    transport_recvd_bytes: int = 0
    transport_ctrl_bytes: int = 0
    transport_data_bytes: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_flat(cls, data: Dict[str, Any]) -> "ServeMetrics":
        """Build from a flat metrics dict: typed keys are lifted into
        fields, the remainder lands in ``extra`` (insertion order
        preserved for ``as_dict`` round-trips)."""
        fields = {k: data[k] for k in _TYPED_FIELDS if k in data}
        extra = {k: v for k, v in data.items() if k not in _TYPED_FIELDS}
        return cls(extra=extra, **fields)

    # ------------------------------------------------------------ mapping
    def _canonical(self, key: str) -> str:
        """Resolve a legacy alias to its canonical key (warning once per
        call site); unknown keys pass through untouched."""
        canon = LEGACY_ALIASES.get(key)
        if canon is None and key.startswith("pool_"):
            tail = key[len("pool_"):]
            if tail in _TYPED_FIELDS or tail in self.extra:
                canon = tail
        if canon is not None:
            warnings.warn(
                f"metrics key {key!r} is deprecated; use {canon!r}",
                DeprecationWarning, stacklevel=3)
            return canon
        return key

    def __getitem__(self, key: str) -> Any:
        key = self._canonical(key)
        if key in _TYPED_FIELDS:
            return getattr(self, key)
        return self.extra[key]

    def __iter__(self) -> Iterator[str]:
        yield from _TYPED_FIELDS
        yield from self.extra

    def __len__(self) -> int:
        return len(_TYPED_FIELDS) + len(self.extra)

    def as_dict(self) -> Dict[str, Any]:
        """The legacy plain-dict shape (canonical keys only)."""
        out = {k: getattr(self, k) for k in _TYPED_FIELDS}
        out.update(self.extra)
        return out

"""Structured generation configuration for the serving front-end.

Before this layer, request knobs were loose arguments scattered across
``Request`` (``max_new_tokens``, ``speculate``) and whatever each caller
bolted on. ``GenerationConfig`` is the one structured, validated bag of
knobs a request carries; validation happens **once**, at construction
(i.e. at admission time for the public API — a malformed config never
reaches the decode loop).

Fields:

* ``max_tokens``     — generation budget (>= 1). The only required knob.
* ``speculate``      — speculative-decoding cap for this request: ``None``
  rides the engine default K, ``0`` disables speculation, ``k`` caps the
  drafts per verify step (further capped by the engine's compiled K).
* ``stop``           — stop sequences as token-id sequences. Generation
  finishes as soon as the emitted tokens *end with* any stop sequence;
  the stop sequence itself is excluded from the output. Checked on the
  host in the step-completion continuation, so streamed and
  retirement-time token lists are identical by construction.
* ``temperature``    — ``0.0`` = greedy argmax (the only decode mode this
  engine implements; the verify step's token-identity guarantee is
  defined against greedy). Non-zero values are rejected at validation —
  the field exists so admission, not the decode loop, owns the check.
* ``deadline_s``     — QoS deadline in seconds, measured from request
  arrival. Queued requests past their deadline are refused at admission;
  in-slot requests are retired (state ``EXPIRED``, pages released) by the
  step-completion continuation that notices the expiry.
* ``priority``       — QoS priority (higher = sooner, default 0).
  Admission pops strictly by priority (arrival order within a class) and
  the engine tags step continuations carrying priority>0 work with the
  scheduler's per-registration ``priority`` flag (front-of-ready-queue).
* ``stream_buffer``  — per-stream pending-token watermark: a consumer
  further than this many tokens behind the decode loop marks the stream
  ``lagging`` (delivery degrades to catch-up bursts; the loop itself
  never blocks and no token is ever dropped).
* ``tenant``         — the accounting principal the request bills to.
  Single-engine tiers ignore it; the multi-replica ``Router`` keys its
  weighted-fairness scheduler and per-tenant quotas on it. Must be a
  non-empty string (default ``"default"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple


class DeadlineExceeded(Exception):
    """A request's QoS deadline passed before it finished.

    Carries the partially generated tokens (``.tokens``) when the request
    had already produced some.
    """

    def __init__(self, message: str, tokens: Optional[list] = None) -> None:
        super().__init__(message)
        self.tokens = tokens if tokens is not None else []


class QuotaExceeded(Exception):
    """A tenant's outstanding-work quota refused this request at admission.

    Carries the refusing ``tenant`` and a ``retry_after_s`` hint — the
    router's running estimate of how long until that tenant's oldest
    outstanding request retires and frees quota.
    """

    def __init__(self, message: str, *, tenant: str = "default",
                 retry_after_s: float = 0.0) -> None:
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)


def _normalize_stop(stop: Any) -> Tuple[Tuple[int, ...], ...]:
    """Coerce stop sequences to a tuple of non-empty int tuples."""
    if stop is None:
        return ()
    if not isinstance(stop, (list, tuple)):
        raise ValueError("stop must be a sequence of token-id sequences")
    out = []
    for seq in stop:
        if not isinstance(seq, (list, tuple)):
            raise ValueError(
                f"each stop entry must be a token-id sequence, got {seq!r}")
        if len(seq) == 0:
            raise ValueError("empty stop sequence")
        try:
            out.append(tuple(int(t) for t in seq))
        except (TypeError, ValueError):
            raise ValueError(
                f"stop sequences must contain ints, got {seq!r}") from None
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Validated per-request generation knobs (see module docstring)."""

    max_tokens: int = 16
    speculate: Optional[int] = None
    stop: Sequence[Sequence[int]] = ()
    temperature: float = 0.0
    deadline_s: Optional[float] = None
    priority: int = 0
    stream_buffer: int = 64
    tenant: str = "default"

    def __post_init__(self) -> None:
        object.__setattr__(self, "max_tokens", int(self.max_tokens))
        if self.max_tokens < 1:
            raise ValueError(
                f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.speculate is not None:
            object.__setattr__(self, "speculate", int(self.speculate))
            if self.speculate < 0:
                raise ValueError("speculate must be >= 0")
        object.__setattr__(self, "stop", _normalize_stop(self.stop))
        if float(self.temperature) != 0.0:
            raise ValueError(
                f"temperature={self.temperature}: only greedy (0.0) decode "
                "is implemented — the engine's token-identity guarantees "
                "are defined against greedy argmax")
        if self.deadline_s is not None and float(self.deadline_s) <= 0:
            raise ValueError(
                f"deadline_s must be > 0 (seconds from arrival), "
                f"got {self.deadline_s}")
        object.__setattr__(self, "priority", int(self.priority))
        object.__setattr__(self, "stream_buffer", int(self.stream_buffer))
        if self.stream_buffer < 1:
            raise ValueError(
                f"stream_buffer must be >= 1, got {self.stream_buffer}")
        if not isinstance(self.tenant, str) or not self.tenant:
            raise ValueError(
                f"tenant must be a non-empty string, got {self.tenant!r}")

    def merged(self, **overrides: Any) -> "GenerationConfig":
        """A copy with ``overrides`` applied (re-validated)."""
        return dataclasses.replace(self, **overrides)

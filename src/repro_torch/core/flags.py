"""Per-registration continuation flags (the API-redesign layer).

The paper (§3.5) attaches every control knob to the continuation request
at ``MPIX_Continue_init`` time; the follow-up proposal (and the
fibers-vs-pthreads companion paper) argue for *finer* control — flags that
travel with each individual ``MPIX_Continue[all]`` call, so one CR can
aggregate continuations with different completion semantics instead of the
application allocating a CR per knob combination.

``ContinueFlags`` is that per-registration override. Every field defaults
to ``None`` = "inherit the CR's ``ContinueInfo`` default"; a non-``None``
value overrides the CR for this registration only. Resolution happens once,
at registration, into a ``ResolvedPolicy`` carried by the ``Continuation``
itself — routing (poll_only queue vs scheduler), the immediate-completion
fast path, inline-execution eligibility, thread policy, and error policy
are all decided per registration from then on.

Fields (MPIX_CONT_* analogues noted):

* ``enqueue_complete``  — ``False``: an all-complete group reports
  ``flag=True`` without invoking the callback; ``True``: it is enqueued
  through the continuation machinery regardless.
* ``immediate``         — ``True``: the callback is safe to run inline even
  while the registering thread is still inside ``continue_when/all`` (opts
  out of the paper-§3.1 registration guard; MPIX_CONT_IMMEDIATE).
* ``defer_complete``    — ``True``: the callback never runs inline on the
  thread that *discovered* the completion; it is always deferred to a
  drain from an engine entry point (MPIX_CONT_DEFER_COMPLETE). Use when
  the callback takes locks the completing thread may hold.
* ``poll_only``         — route the ready continuation to the CR's private
  queue (runs only inside ``cr.test()``/``wait()``) instead of the
  engine scheduler.
* ``thread``            — "application" / "any": which threads may execute
  the callback (see ``ContinueInfo.thread``).
* ``volatile_statuses`` — ``True``: the caller's ``statuses`` list is
  volatile (may be reused immediately after the call); the engine snapshots
  into an internally-owned list and passes *that* to the callback
  (MPIX_CONT_REQBUF_VOLATILE analogue for the status buffer).
* ``on_error``          — per-registration error policy: ``"raise"`` (re-
  raised from the CR's next test/wait), ``"collect"`` (stored on
  ``cr.errors`` only), or a callable ``fn(exc)`` invoked with the
  exception (never stored).
* ``priority``          — scheduler hint: a registration with
  ``priority > 0`` is pushed to the *front* of the ready queue(s), so its
  callback drains ahead of already-queued normal-priority work (the serve
  front-end maps per-request QoS priority onto this; there is no CR-level
  counterpart — the default is 0).

``make_flags`` accepts a ``ContinueFlags``, a mapping (new-style field
names or the deprecated MPI-style ``mpi_continue_*`` string keys), and/or
kwargs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Union

from repro_torch.core.info import (THREAD_ANY, THREAD_APPLICATION, ContinueInfo,
                             _coerce)

OnError = Union[str, Callable[[BaseException], None]]


@dataclasses.dataclass(frozen=True)
class ContinueFlags:
    """Per-registration overrides; ``None`` inherits the CR info default."""

    enqueue_complete: Optional[bool] = None
    immediate: Optional[bool] = None
    defer_complete: Optional[bool] = None
    poll_only: Optional[bool] = None
    thread: Optional[str] = None
    volatile_statuses: Optional[bool] = None
    on_error: Optional[OnError] = None
    priority: Optional[int] = None

    def __post_init__(self) -> None:
        if self.priority is not None and not isinstance(self.priority, int):
            raise ValueError(f"priority must be an int, "
                             f"got {self.priority!r}")
        if self.thread not in (None, THREAD_APPLICATION, THREAD_ANY):
            raise ValueError(f"thread must be 'application' or 'any', "
                             f"got {self.thread!r}")
        if self.on_error is not None and not callable(self.on_error) \
                and self.on_error not in ("raise", "collect"):
            raise ValueError(
                "on_error must be 'raise', 'collect', or a callable")
        if self.immediate and self.defer_complete:
            raise ValueError(
                "immediate=True (run inline even during registration) and "
                "defer_complete=True (never run inline at discovery) are "
                "contradictory")


@dataclasses.dataclass(frozen=True)
class ResolvedPolicy:
    """Flags resolved against a CR's ``ContinueInfo`` — no ``None`` left.

    Computed once at registration; the ``Continuation`` carries it so every
    later decision (routing, eligibility, error surfacing) is local to the
    registration, not the CR.
    """

    enqueue_complete: bool
    immediate: bool
    defer_complete: bool
    poll_only: bool
    thread: str
    volatile_statuses: bool
    on_error: OnError
    priority: int = 0


#: deprecated MPI-style string keys (mirrors ``core.info._KEYMAP``); kept
#: working so old call sites migrate at their own pace.
_FLAG_KEYMAP = {
    "mpi_continue_enqueue_complete": "enqueue_complete",
    "mpi_continue_immediate": "immediate",
    "mpi_continue_defer_complete": "defer_complete",
    "mpi_continue_poll_only": "poll_only",
    "mpi_continue_thread": "thread",
    "mpi_continue_volatile_statuses": "volatile_statuses",
    "mpi_continue_priority": "priority",
    "on_error": "on_error",
}

_BOOL_FIELDS = ("enqueue_complete", "immediate", "defer_complete",
                "poll_only", "volatile_statuses")


def make_flags(flags: Union[None, ContinueFlags, Mapping[str, Any]] = None,
               /, **kwargs: Any) -> Optional[ContinueFlags]:
    """Normalize a flags argument (instance, mapping, kwargs) or ``None``."""
    if flags is None and not kwargs:
        return None
    if isinstance(flags, ContinueFlags):
        if kwargs:
            return dataclasses.replace(flags, **kwargs)
        return flags
    fields: dict[str, Any] = {}
    for key, value in (flags or {}).items():
        field = _FLAG_KEYMAP.get(key, key)
        if field not in ContinueFlags.__dataclass_fields__:
            raise KeyError(f"unknown continuation flag: {key!r}")
        fields[field] = value
    fields.update(kwargs)
    for key in list(fields):
        if key in _BOOL_FIELDS and fields[key] is not None:
            fields[key] = _coerce("poll_only", fields[key])  # bool coercion
    return ContinueFlags(**fields)


def merge_flags(base: Optional[ContinueFlags],
                override: Optional[ContinueFlags]) -> Optional[ContinueFlags]:
    """Layer two flag sets: any non-``None`` field of ``override`` wins."""
    if override is None:
        return base
    if base is None:
        return override
    picked = {
        name: (getattr(override, name) if getattr(override, name) is not None
               else getattr(base, name))
        for name in ContinueFlags.__dataclass_fields__}
    return ContinueFlags(**picked)


def resolve(info: ContinueInfo,
            flags: Optional[ContinueFlags]) -> ResolvedPolicy:
    """CR info defaults, overridden by any non-``None`` per-registration
    flag. ``immediate``/``defer_complete``/``volatile_statuses`` (default
    ``False``) and ``priority`` (default 0) have no CR-level
    counterpart."""
    if flags is None:
        return ResolvedPolicy(
            enqueue_complete=info.enqueue_complete, immediate=False,
            defer_complete=False, poll_only=info.poll_only,
            thread=info.thread, volatile_statuses=False,
            on_error=info.on_error, priority=0)

    def pick(override, default):
        return default if override is None else override

    return ResolvedPolicy(
        enqueue_complete=pick(flags.enqueue_complete, info.enqueue_complete),
        immediate=pick(flags.immediate, False),
        defer_complete=pick(flags.defer_complete, False),
        poll_only=pick(flags.poll_only, info.poll_only),
        thread=pick(flags.thread, info.thread),
        volatile_statuses=pick(flags.volatile_statuses, False),
        on_error=pick(flags.on_error, info.on_error),
        priority=pick(flags.priority, 0))

"""Info-key controls for continuation requests (paper §3.5).

These are now the CR-level *defaults*: any individual registration may
override them with per-registration ``ContinueFlags`` (``core.flags``,
the ``flags=`` argument of ``continue_when``/``continue_all``/the
combinators). The MPI-style ``mpi_continue_*`` string keys accepted by
``make_info`` are deprecated in favour of field-name kwargs, but keep
working — existing call sites migrate at their own pace.

Five keys, mirrored 1:1 from the paper:

* ``poll_only``          — callbacks run only inside an explicit completion
                           call (``cr.test()`` / ``cr.wait()``) on *this* CR.
* ``enqueue_complete``   — ``continue_when/all`` never reports immediate
                           completion; already-complete ops are enqueued.
* ``max_poll``           — cap on callbacks executed per test of this CR
                           (-1 = unlimited).
* ``thread``             — "application": callbacks only on threads that call
                           into the engine; "any": engine-internal progress /
                           waiter threads may run them.
* ``async_signal_safe``  — hint retained from the paper; in this Python
                           runtime it additionally permits execution on timer
                           threads (documented adaptation, DESIGN.md §2).

``poll_only=True`` with ``max_poll=0`` is erroneous (paper: no continuation
registered with such a CR could ever run).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

THREAD_APPLICATION = "application"
THREAD_ANY = "any"


@dataclasses.dataclass(frozen=True)
class ContinueInfo:
    poll_only: bool = False
    enqueue_complete: bool = False
    max_poll: int = -1
    thread: str = THREAD_APPLICATION
    async_signal_safe: bool = False
    #: beyond-paper framework key: how callback exceptions surface
    #: ("raise" = re-raised from the next test/wait; "collect" = stored)
    on_error: str = "raise"

    def __post_init__(self) -> None:
        if self.thread not in (THREAD_APPLICATION, THREAD_ANY):
            raise ValueError(f"mpi_continue_thread must be 'application' or "
                             f"'any', got {self.thread!r}")
        if self.max_poll < -1:
            raise ValueError("mpi_continue_max_poll must be >= -1")
        if self.poll_only and self.max_poll == 0:
            raise ValueError(
                "mpi_continue_poll_only=true with mpi_continue_max_poll=0 is "
                "erroneous: no continuation could ever be executed (paper §3.5)")
        if self.on_error not in ("raise", "collect"):
            raise ValueError("on_error must be 'raise' or 'collect'")


_KEYMAP = {
    "mpi_continue_poll_only": "poll_only",
    "mpi_continue_enqueue_complete": "enqueue_complete",
    "mpi_continue_max_poll": "max_poll",
    "mpi_continue_thread": "thread",
    "mpi_continue_async_signal_safe": "async_signal_safe",
    "on_error": "on_error",
}


def _coerce(field: str, value: Any) -> Any:
    if field in ("poll_only", "enqueue_complete", "async_signal_safe"):
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes")
        return bool(value)
    if field == "max_poll":
        return int(value)
    return value


def make_info(info: Optional[Mapping[str, Any]] = None, /, **kwargs: Any) -> ContinueInfo:
    """Build a ``ContinueInfo`` from MPI-style string keys and/or kwargs."""
    fields: dict[str, Any] = {}
    for key, value in (info or {}).items():
        field = _KEYMAP.get(key, key)
        if field not in ContinueInfo.__dataclass_fields__:
            raise KeyError(f"unknown continuation info key: {key!r}")
        fields[field] = _coerce(field, value)
    for key, value in kwargs.items():
        if key not in ContinueInfo.__dataclass_fields__:
            raise KeyError(f"unknown continuation info key: {key!r}")
        fields[key] = _coerce(key, value)
    return ContinueInfo(**fields)

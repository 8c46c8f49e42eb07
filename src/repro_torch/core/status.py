"""Completion status objects — the analogue of ``MPI_Status``.

The paper requires that status objects are *set before the continuation is
invoked* (or before ``MPIX_Continue[all]`` returns on immediate completion)
and that callbacks can detect cancellation (``MPI_Test_cancelled``,
paper Listing 4). We model that contract here.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Any, Optional

# Sentinel mirroring MPI_STATUS_IGNORE: caller does not want a status.
STATUS_IGNORE = None


class OpState(enum.Enum):
    """Lifecycle of a completable operation."""

    PENDING = "pending"
    COMPLETE = "complete"
    CANCELLED = "cancelled"
    FAILED = "failed"


@dataclasses.dataclass
class Status:
    """Completion record handed to a continuation callback.

    Mirrors ``MPI_Status``: identifies the source/tag of a message-like
    operation, whether the op was cancelled, an error (if any) and an
    op-specific payload (e.g. the received message, the ready tensor,
    the written checkpoint path).
    """

    source: Optional[int] = None
    tag: Optional[int] = None
    cancelled: bool = False
    error: Optional[BaseException] = None
    payload: Any = None
    #: number of payload bytes, where meaningful (message ops)
    count: int = 0

    def test_cancelled(self) -> bool:
        """``MPI_Test_cancelled`` analogue (paper Listing 4)."""
        return self.cancelled

    def raise_for_error(self) -> None:
        if self.error is not None:
            raise self.error


class OneShotLatch:
    """A tiny single-transition latch used by ops to publish completion.

    Thread-safe; ``fire`` is idempotent and returns True only for the first
    caller, so completion hooks run exactly once no matter how many threads
    race on the transition (multiple application threads may be inside the
    engine concurrently — paper §3).
    """

    __slots__ = ("_fired", "_lock")

    def __init__(self) -> None:
        self._fired = False
        self._lock = threading.Lock()

    @property
    def fired(self) -> bool:
        return self._fired

    def fire(self) -> bool:
        with self._lock:
            if self._fired:
                return False
            self._fired = True
            return True

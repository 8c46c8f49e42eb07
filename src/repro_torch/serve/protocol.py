"""The formal engine protocol every serving tier satisfies.

Three tiers grew the same surface organically — the colocated
``ServeEngine``, the disaggregated ``DisaggServer`` facade, and the
multi-replica ``Router`` — and ``ServeClient`` binds to whichever one it
is handed. ``EngineLike`` makes that contract explicit: anything with
``submit / step / run / metrics / shutdown`` (plus the ``idle`` /
``batcher`` / ``retired`` attributes the client's drain logic reads) IS
a serving engine, checkable at runtime via ``isinstance`` thanks to
``typing.runtime_checkable``.

The protocol is deliberately structural, not nominal: the tiers share no
base class (``DisaggServer`` and ``Router`` are facades composing
engines over a transport, not engine subclasses), and a mesh-backed
implementation living outside this repo should satisfy it without
importing anything but this module.
"""
from __future__ import annotations

from typing import (Any, List, Mapping, Optional, Protocol,
                    runtime_checkable)

from repro_torch.serve.request import Request


@runtime_checkable
class EngineLike(Protocol):
    """Structural contract for a serving engine tier.

    Single-consumer loop semantics: exactly one thread drives
    ``step()``/``run()``; any thread may ``submit()``. ``metrics()``
    returns a read-only mapping (``serve.metrics.ServeMetrics`` for the
    in-repo tiers).
    """

    # one intake queue: the client's drain logic reads .closed/.drained
    batcher: Any

    def submit(self, request: Request) -> Request:
        """Thread-safe intake; returns the (validated) request."""
        ...

    def close_intake(self) -> None:
        """Refuse further submissions (the client's drain handshake)."""
        ...

    def step(self) -> bool:
        """One loop iteration; True if any work started or completed."""
        ...

    def run(self, timeout: Optional[float] = None,
            idle_sleep: float = 5e-5, until=None) -> List[Request]:
        """Drive the loop until drained (or ``until()`` flips true)."""
        ...

    def metrics(self) -> Mapping[str, Any]:
        """Snapshot of serving metrics (see ``serve.metrics``)."""
        ...

    def shutdown(self) -> None:
        """Release resources; idempotent."""
        ...

    @property
    def idle(self) -> bool:
        """Nothing queued, occupied, or in flight."""
        ...

    @property
    def retired(self) -> List[Request]:
        """Requests that finished (any terminal success path)."""
        ...

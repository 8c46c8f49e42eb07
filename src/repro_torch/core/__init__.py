"""MPI-Continuations-style completion-notification runtime for PyTorch.

A copy of the reference package's runtime with one real change: the
device-work completion op is ``TensorOp`` (a CUDA event polled with
``query()``) in place of the JAX ``ArrayOp``. Public API (names mirror the
paper's interface):

    engine = Engine()                      # or default_engine()
    cr = engine.continue_init(info)        # MPIX_Continue_init (defaults)
    flag = engine.continue_when(op, cb, cb_data, status, cr, flags)  # MPIX_Continue
    flag = engine.continue_all(ops, cb, cb_data, statuses, cr, flags)  # MPIX_Continueall
    flag = engine.continue_any(ops, cb, ..., indices=idx, cr=cr)   # Testany-style
    flag = engine.continue_some(ops, k, cb, ..., indices=idx, cr=cr)  # Waitsome-style
    cr.test() / cr.wait() / cr.free()      # MPI_Test / MPI_Wait / Request_free

``Transport`` (in-process MPI-style messaging between rank threads) orders
a CUDA-tensor payload by a ``TensorOp`` on the sender's stream: the message
is matchable once the data is ready (see ``core.transport``).
"""
from repro_torch.core.completable import (CombinedOp, Completable,
                                          HostTaskOp, PredicateOp, TensorOp,
                                          TimerOp, when_all, when_any,
                                          when_some)
from repro_torch.core.continuation import (CallbackError,
                                           ConcurrentCompletionError,
                                           Continuation, ContinuationRequest,
                                           CRState)
from repro_torch.core.engine import (Engine, default_engine,
                                     reset_default_engine)
from repro_torch.core.flags import ContinueFlags, ResolvedPolicy, make_flags
from repro_torch.core.info import (THREAD_ANY, THREAD_APPLICATION,
                                   ContinueInfo, make_info)
from repro_torch.core.progress import Progress
from repro_torch.core.promise import Promise, PromiseCancelled, Signal
from repro_torch.core.scheduler import (AffinityScheduler, FifoScheduler,
                                        Scheduler, make_scheduler)
from repro_torch.core.status import STATUS_IGNORE, OpState, Status
from repro_torch.core.testsome import TestsomeManager
from repro_torch.core.transport import (ANY_SOURCE, ANY_TAG, RecvOp, SendOp,
                                        Transport)

__all__ = [
    "TensorOp", "CombinedOp", "Completable", "HostTaskOp", "PredicateOp",
    "TimerOp", "when_all", "when_any", "when_some",
    "CallbackError", "ConcurrentCompletionError", "Continuation",
    "ContinuationRequest", "CRState", "Engine", "default_engine",
    "reset_default_engine", "THREAD_ANY", "THREAD_APPLICATION",
    "ContinueInfo", "make_info", "ContinueFlags", "ResolvedPolicy",
    "make_flags", "STATUS_IGNORE", "OpState", "Status",
    "Progress", "Promise", "PromiseCancelled", "Signal", "Scheduler",
    "FifoScheduler", "AffinityScheduler", "make_scheduler",
    "TestsomeManager", "ANY_SOURCE", "ANY_TAG", "RecvOp", "SendOp",
    "Transport",
]

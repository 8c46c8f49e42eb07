"""Serving subsystem of the port: continuation-driven continuous batching.

Layers (counterparts of ``repro.serve``):

* ``serve.steps``    — prefill / dense decode / batched slot decode /
  paged decode, verify and suffix steps (fused and unfused), the prefill
  scatter, and the ``greedy_generate`` oracle.
* ``serve.graphs``   — ``StepGraph``: a fixed-shape step captured as one
  CUDA graph on the card (the counterpart of the reference's ``jax.jit``),
  run eagerly on the CPU.
* ``serve.config``   — ``GenerationConfig``: per-request knobs validated
  once at admission.
* ``serve.request``  — request lifecycle; each ``Request`` is a
  ``Completable``, and per-token delivery runs in the engine's
  step-completion continuations.
* ``serve.batcher``  — thread-safe admission on a ``poll_only +
  enqueue_complete`` CR.
* ``serve.drafter``  — the ``Drafter`` protocol for self-speculative
  decoding (default: n-gram prompt lookup).
* ``serve.kv_cache`` — paged KV block pool with content-hashed prefix
  reuse.
* ``serve.engine``   — the decode loop: each step's output is a
  ``TensorOp`` (a CUDA event) whose continuation delivers tokens and
  retires slots.
* ``serve.api``      — the streaming front end: ``ServeClient`` /
  ``Session`` / ``TokenStream``, fed by the same continuations.
* ``serve.protocol`` — ``EngineLike``, the structural protocol a serving
  tier satisfies (``ServeClient`` binds to any).
* ``serve.metrics``  — ``ServeMetrics``, the typed metrics mapping.
* ``serve.disagg``   — disaggregated prefill/decode roles over the
  transport: KV pages shipped as device tensors (``DisaggServer``).
* ``serve.router``   — the multi-replica front door: prefix affinity,
  tenant fairness (``FairBatcher``, ``QuotaExceeded``), heartbeat
  failover with token-identical replay (``Router``).
"""
from repro_torch.serve.api import ServeClient, Session, TokenStream
from repro_torch.serve.batcher import Batcher, FairBatcher
from repro_torch.serve.config import (DeadlineExceeded, GenerationConfig,
                                      QuotaExceeded)
from repro_torch.serve.disagg import (DecodeWorker, DisaggServer, KVBlockMsg,
                                      PrefillWorker, serve_requests_disagg)
from repro_torch.serve.drafter import Drafter, NgramDrafter, RepeatDrafter
from repro_torch.serve.engine import ServeEngine, serve_requests
from repro_torch.serve.graphs import StepGraph
from repro_torch.serve.kv_cache import (PagePool, pages_for,
                                        paged_supported, prefix_keys)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.protocol import EngineLike
from repro_torch.serve.request import Request, RequestState, summarize
from repro_torch.serve.router import ReplicaWorker, Router
from repro_torch.serve.steps import (greedy_generate,
                                     make_batched_decode_step,
                                     make_decode_step,
                                     make_fused_paged_decode_step,
                                     make_fused_paged_suffix_step,
                                     make_fused_paged_verify_step,
                                     make_paged_decode_step,
                                     make_paged_suffix_step,
                                     make_paged_verify_step,
                                     make_prefill_scatter, make_prefill_step)

__all__ = [
    "Batcher", "DeadlineExceeded", "GenerationConfig", "ServeEngine",
    "serve_requests", "PagePool", "pages_for", "paged_supported",
    "prefix_keys", "ServeMetrics", "Request", "RequestState", "summarize",
    "greedy_generate", "make_batched_decode_step", "make_decode_step",
    "make_fused_paged_decode_step",
    "make_fused_paged_suffix_step", "make_fused_paged_verify_step",
    "make_paged_decode_step", "make_paged_suffix_step",
    "make_paged_verify_step", "make_prefill_scatter", "make_prefill_step",
    "StepGraph", "Drafter",
    "NgramDrafter", "RepeatDrafter", "ServeClient", "Session", "TokenStream",
    "EngineLike", "FairBatcher", "QuotaExceeded", "DecodeWorker",
    "DisaggServer", "KVBlockMsg", "PrefillWorker", "serve_requests_disagg",
    "ReplicaWorker", "Router",
]
